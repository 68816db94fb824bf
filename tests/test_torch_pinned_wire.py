"""Page-locked wires: every crossing between the card and a wire is one DMA.

On a CUDA buffer, ``pack_bytes_from_numeric``, ``pack_row_bytes`` and the
int8 and top-k encoders copy into page-locked host memory from PyTorch's
caching host allocator, and the numpy wire is a view of it; ``host_tensor``
copies such a wire back to the card by one DMA.  The bytes are the ones the
pageable path made (``_pageable_*`` below, the code as it stood before), and
a CUDA channel counts each crossing in ``channel.pinned_copies`` or
``channel.pageable_copies`` and notes it on its span.  A host channel never
asks for page-locked memory and registers neither counter.

The card's tests skip without one (decided inside the ``cuda_device``
fixture).  This file imports neither JAX nor the reference, so it runs where
only the port is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_pinned_wire.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import housing_mlp
from repro_torch.core import Driver, FederationEnv, TerminationCriteria, tracing
from repro_torch.core import packing as tpack
from repro_torch.core.transport import Channel, TopkUploadCodec
from repro_torch.launch import train
from repro_torch.models import mlp

COPY_SPANS = {"controller.broadcast", "learner.recv", "learner.encode", "controller.decode"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locked memory and its DMA exist only there")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the pageable path, as the wire was made before page-locked wires
# ---------------------------------------------------------------------------


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _pageable_from_numeric(buffer, manifest):
    host = buffer.detach()[: manifest.total_elements].cpu()
    dtypes = {s.dtype for s in manifest.specs}
    if len(dtypes) == 1:
        return _bytes(host.to(tpack.torch_dtype(dtypes.pop()), copy=True))
    out = np.empty((manifest.total_bytes,), np.uint8)
    cursor = 0
    for spec in manifest.specs:
        seg = host[spec.offset: spec.offset + spec.size].to(tpack.torch_dtype(spec.dtype))
        out[cursor: cursor + spec.nbytes] = _bytes(seg)
        cursor += spec.nbytes
    return out


def _pageable_row(buffer, dtype):
    return _bytes(buffer.detach().reshape(-1).to("cpu", dtype, copy=True))


def _nan_payloads(buf):
    """Overwrite a few f32 values with NaNs that carry payload bits, and
    values no narrower dtype holds, so a cast has rounding to do."""
    bits = buf.view(torch.int32)
    bits[3] = 0x7FC00001
    bits[5] = -0x005EDCBB  # 0xFFA12345, a signalling NaN with its sign bit set
    buf[7] = 1.0 + 2.0 ** -20
    return buf


def _tree(dtypes, device):
    g = torch.Generator().manual_seed(0)
    sizes = [(5, 7), (13,), (3, 11)]
    return {f"leaf{i}": (torch.randn(shape, generator=g) * 3).to(dt).to(device)
            for i, (shape, dt) in enumerate(zip(sizes, dtypes))}


_F32, _BF16, _I32 = torch.float32, torch.bfloat16, torch.int32
CASES = {
    # name: (manifest dtypes or None for a row, buffer dtype, wire dtype, pad_to)
    "f32_row": (None, _F32, _F32, None),
    "bf16_row_as_f32": (None, _BF16, _F32, None),
    "f32_padded": ((_F32, _F32, _F32), _F32, None, 64),
    "homogeneous_bf16": ((_BF16, _BF16, _BF16), _F32, None, 64),
    "mixed": ((_F32, _BF16, _I32), _F32, None, None),
}


def _wires(case, device):
    """``(the wire, the pageable path's bytes)`` of one case on ``device``."""
    dtypes, buf_dtype, wire_dtype, pad_to = CASES[case]
    if dtypes is None:
        row = _nan_payloads(torch.randn(1001, generator=torch.Generator().manual_seed(1)))
        row = row.to(buf_dtype).to(device)
        return tpack.pack_row_bytes(row, wire_dtype), _pageable_row(row, wire_dtype)
    tree = _tree(dtypes, device)
    manifest = tpack.build_manifest(tree)
    buf = tpack.pack_numeric(tree, dtype=buf_dtype, pad_to=pad_to)
    if pad_to is not None:
        assert buf.shape[0] > manifest.total_elements
    if dtypes[0] == _BF16:
        buf = _nan_payloads(buf)
    return tpack.pack_bytes_from_numeric(buf, manifest), _pageable_from_numeric(buf, manifest)


class _Sink:
    def __init__(self):
        self.spans = []

    def record_span(self, name, t, t_end, **fields):
        self.spans.append((name, fields))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_card_wires_are_page_locked_and_bit_identical(cuda_device, case):
    wire, want = _wires(case, cuda_device)
    assert wire.dtype == np.uint8 and wire.tobytes() == want.tobytes()
    assert tpack.wire_is_pinned(wire)
    assert torch.from_numpy(wire).is_pinned()
    assert not tpack.wire_is_pinned(want)


@pytest.mark.cuda
def test_a_broadcast_wire_keeps_its_bytes_while_held(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    tree = {"w": torch.randn((1000, 257), generator=g, device=cuda_device)}
    manifest = tpack.build_manifest(tree)
    ch = Channel(device=cuda_device)
    src = tpack.pack_numeric(tree, pad_to=1024)
    bc = ch.broadcast(buffer=src, manifest=manifest, version=0)
    want, held = bc.buffer.tobytes(), bc.buffer.ctypes.data
    del src, tree
    torch.cuda.empty_cache()
    seen = []
    for i in range(10):
        other = torch.randn((manifest.total_elements + 1000,), generator=g, device=cuda_device)
        later = ch.broadcast(buffer=other, manifest=manifest, version=i + 1)
        up = ch.upload(other)
        seen += [later.buffer.ctypes.data, up.payload.ctypes.data]
        assert bc.buffer.tobytes() == want
        del later, up
    assert held not in seen
    # Released blocks go back to the cache and are handed out again.
    assert len(set(seen)) < len(seen)
    got = ch.recv(bc.to({"learner_id": "a"}))
    assert tpack.pack_row_bytes(got["w"].reshape(-1)).tobytes() == want


@pytest.mark.cuda
def test_host_tensor_lands_a_pinned_wires_bytes(cuda_device):
    row = torch.randn(4099, device=cuda_device)
    wire = tpack.pack_row_bytes(row)
    assert tpack.wire_is_pinned(wire)
    wire.flags.writeable = False
    dev = tpack.host_tensor(wire, cuda_device)
    assert dev.device.type == "cuda" and dev.dtype == torch.uint8
    assert dev.cpu().numpy().tobytes() == wire.tobytes()
    back = tpack.unpack_row_bytes(wire, 4099, "float32", cuda_device)
    assert torch.equal(back.view(torch.int32), row.view(torch.int32))


@pytest.mark.cuda
def test_a_cuda_channel_counts_its_crossings_pinned(cuda_device):
    tree = _tree((_F32, _F32, _F32), cuda_device)
    manifest = tpack.build_manifest(tree)
    buf = tpack.pack_numeric(tree, pad_to=256)
    row = torch.randn(2048, device=cuda_device)
    ch, sink = Channel(device=cuda_device), _Sink()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), \
            tracing.bind(sink):
        bc = ch.broadcast(buffer=buf, manifest=manifest, version=0)
        got = ch.recv(bc.to({"learner_id": "a"}))
        for codec in ("raw", "int8", TopkUploadCodec(k=64)):
            ch.recv_upload(ch.upload(row, codec=codec), with_norm=True)
    assert all(torch.equal(got[k], tree[k]) for k in tree)
    assert ch.stats.pinned_copies == 8 and ch.stats.pageable_copies == 0
    marked = [(name, f["pinned"]) for name, f in sink.spans if "pinned" in f]
    assert {name for name, _ in marked} == COPY_SPANS and len(marked) == 8
    assert all(pinned for _, pinned in marked)

    # A tree's leaves are packed into pageable memory (`pack_bytes`), and a
    # wire built on the host crosses to the card from pageable memory.
    envelope = ch.send(tree)
    ch.recv(envelope)
    host_ch = Channel(device="cpu")
    ch.recv_upload(host_ch.upload(row.cpu()))
    assert ch.stats.pinned_copies == 8 and ch.stats.pageable_copies == 3


@pytest.mark.cuda
def test_a_card_federation_moves_every_wire_by_dma(cuda_device):
    _, learners = train.build_housing_learners("100k", 3, 0, device=cuda_device)
    init = mlp.init_params(torch.Generator().manual_seed(0), housing_mlp.reduced(), cuda_device)
    driver = Driver(FederationEnv(protocol="sync", local_steps=2, batch_size=16,
                                  termination=TerminationCriteria(max_rounds=2),
                                  device=cuda_device))
    driver.initialize(init, learners)
    driver.run()
    tel = driver.controller.telemetry
    crossings = sum(tel.value(f"channel.{f}") for f in (
        "serializations", "messages", "upload_serializations", "upload_messages"))
    assert tel.value("channel.pageable_copies") == 0
    assert tel.value("channel.pinned_copies") == crossings > 0


# ---------------------------------------------------------------------------
# the host
# ---------------------------------------------------------------------------


@pytest.fixture
def pin_requests(monkeypatch):
    """Every request for page-locked memory made while the test runs."""
    seen = []
    empty = torch.empty

    def spy_empty(*args, **kwargs):
        if kwargs.get("pin_memory"):
            seen.append("empty")
        return empty(*args, **kwargs)

    def spy_pin(self, *args, **kwargs):
        seen.append("pin_memory")
        raise AssertionError("a host wire asked for page-locked memory")

    monkeypatch.setattr(torch, "empty", spy_empty)
    monkeypatch.setattr(torch.Tensor, "pin_memory", spy_pin)
    return seen


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_wires_are_the_pageable_paths_bytes(case, pin_requests):
    wire, want = _wires(case, "cpu")
    assert wire.tobytes() == want.tobytes()
    assert not tpack.wire_is_pinned(wire)
    assert pin_requests == []


def test_a_host_channels_round_trip_never_pins(pin_requests):
    tree = _tree((_F32, _BF16, _I32), "cpu")
    manifest = tpack.build_manifest(tree)
    buf = tpack.pack_numeric(tree, pad_to=64)
    row = torch.randn(2048, generator=torch.Generator().manual_seed(3))
    ch, sink = Channel(device="cpu"), _Sink()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), \
            tracing.bind(sink):
        bc = ch.broadcast(buffer=buf, manifest=manifest, version=0)
        got = ch.recv(bc.to({"learner_id": "a"}))
        rows = [ch.recv_upload(ch.upload(row, codec=codec))
                for codec in ("raw", "int8", TopkUploadCodec(k=64))]
    assert bc.buffer.tobytes() == _pageable_from_numeric(buf, manifest).tobytes()
    assert all(torch.equal(got[k], tree[k]) for k in tree)
    assert torch.equal(rows[0], row)
    assert pin_requests == []
    assert not {"channel.pinned_copies", "channel.pageable_copies"} & set(ch.telemetry.names())
    assert ch.stats.pinned_copies == 0 and ch.stats.pageable_copies == 0
    assert {name for name, _ in sink.spans} >= COPY_SPANS
    assert not any("pinned" in fields for _, fields in sink.spans)


def test_a_host_federation_never_pins(pin_requests):
    _, learners = train.build_housing_learners("100k", 3, 0, device="cpu")
    init = mlp.init_params(torch.Generator().manual_seed(0), housing_mlp.reduced(), "cpu")
    driver = Driver(FederationEnv(protocol="sync", local_steps=2, batch_size=16,
                                  termination=TerminationCriteria(max_rounds=2), device="cpu"))
    driver.initialize(init, learners)
    driver.run()
    tel = driver.controller.telemetry
    assert tel.value("channel.upload_messages") == 6
    assert tel.value("channel.pinned_copies") == 0
    assert "channel.pinned_copies" not in tel.names()
    assert pin_requests == []


def test_wire_is_pinned_reads_the_memory_a_wire_views():
    owned = np.zeros(16, np.uint8)
    assert not tpack.wire_is_pinned(owned)
    view = torch.zeros(4).view(torch.uint8).numpy()[2:]
    view.flags.writeable = False
    assert not tpack.wire_is_pinned(view)
