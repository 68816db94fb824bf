"""The port on the card: the hand-written kernels and sync rounds through them.

Needs a CUDA card; every test skips without one (decided inside the
``cuda_device`` fixture, never at import).  This file imports neither JAX nor
the reference, so it runs where only the port is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Kernel bars: atol = rtol = 1e-5 for f32 rows, 3e-2 for bf16 rows, against
the plain torch version on the same card and the f64 host oracle (FedAvg
also at the main path's full widths, where every block walks several tiles
and the arena passes 2^31 bytes, at N = 1,100 and 2,500, on an unaligned
view, at P of 1, 3 and 5, with one live row among NaN ones, zero weights and
the empty mask, two launches bit-identical, one device kernel per wrapper
call); quantize
and dequantize bit-identical to their plain versions (``ops.quantize`` on
unpadded rows with ragged tails, one launch that writes the wire's layout;
dequantize on its persistent grid's edges: odd group counts of group 8,
groups 24 and 4096 over one round and two, one grid stride -+ 16 values);
the fused dequant-into-aggregate at atol = rtol = 2e-5 (at full width all
live and 8 of 32 live under staleness weights, group 512, N = 2,049,
unaligned views, a view past 2^31 bytes; bit-identical to the f32 FedAvg
kernel on the dequantized rows and across launches, dead rows' garbage
changing no bit, one device kernel a call); the masked trimmed
mean at atol = rtol = 1e-5 in f32 and bf16 alike (both versions widen bf16
to f32 exactly and sum the band in sorted order, up to the torch
reduction's grouping), on both sides of each of the sorting network's
template sizes and of the switch to the rank-select past 64 rows, and at
full width; each of quantize and the trimmed mean one device kernel a call.
The robust rules' sorts (both medians, both trimmed means' plain versions)
equal the host's bit for bit with a negative and a positive NaN in live rows.
The model axis: a sharded decode step of reduced gemma3-4b over 8 slots of
the card shows no memcpy to the profiler and matches the host; the
expert-parallel MoE's dispatch and 2-D decode bodies, MLA's sharded decode,
each on slots of the card against the host at rtol 1e-4 / atol 1e-5.
The column-sharded arena: kernels 1, 5 and 6 once a slot on four shards of
the 10m arena, one card, bit-identical to one launch on the whole arena; the
sharded scatter bit-identical to the unsharded one; a sharded sync federation
bit-identical to the unsharded one.
Secure aggregation: ``encode_fixed`` and the masked sum on the card equal the
host's bit for bit (NaN, ±inf, values past ±2^31 once scaled, sums that wrap),
though the card's pads (Philox) are not the host's (mt19937); the pads' sign
bit is set in about half the draws.  The f32, int8 and sparse arenas'
``export_state``/``restore_state`` round trip through ``.npz`` is
byte-identical at full width.  The top-k uplink: a full-width encode
(10,174,464 values with planted ties, ±0 and NaN of both signs, k =
158,976) gives the host's wire bytes for f32 and int8 values; selection,
``densify`` and ``ef_residual`` equal the host's bits with ±NaN and ties
(a NaN result compared as NaN: the card's arithmetic returns its own);
the scatter-accumulate of a ``(32, 158,976)`` sparse arena gives the same
bits on two calls and equals the host's to rtol 1e-6.  The dense LM:
kernels 1 and 5 at fedlm-100m's ``(32, 73,937,920)`` arenas (9.46 GB f32,
past 2^31 elements; 2.37 GB int8) with NaN dead rows against their plain
versions (1e-5, 2e-5), and fedlm-100m's full-width f32 forward and loss on
the card against the host at rtol 1e-4 / atol 1e-5.  The other families:
kernel 1 at the one-layer qwen2-moe-a2.7b's ``(4, 1,228,025,856)`` arena
(19.65 GB, past 2^31 elements) with a NaN dead row; each new family's
reduced f32 forward and loss, and the dense MoE, MLA and the chunked SSD,
card against host at rtol 1e-4 / atol 1e-5 (the MoE's atol scaled to its
outputs' magnitude).
"""

import dataclasses


import numpy as np
import pytest
import torch

from repro_torch.configs import fedlm_100m, housing_mlp
from repro_torch.core import Driver, FederationEnv, TerminationCriteria
from repro_torch.core import aggregation as tagg
from repro_torch.core import secure as tsec
from repro_torch.core import transport as ttransport
from repro_torch.core.store import ArenaStore
from repro_torch.kernels import fedavg as tfed
from repro_torch.kernels import fused_agg as tfused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import ref as tref
from repro_torch.kernels import robust as trobust
from repro_torch.kernels import sparse_agg as tsparse
from repro_torch.kernels import topk as ttopk
from repro_torch.device import full_f32
from repro_torch.launch import train
from repro_torch.models import mlp, transformer
from repro_torch.tree import tree_map

pytestmark = pytest.mark.cuda

_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
P_MAIN = 10_174_464  # housing-mlp-10m's arena row
P_STACK = 10_174_081  # the stack leg's unpadded rows, not 16-byte aligned
P_LM = 73_937_920  # fedlm-100m's arena row: 73,937,664 params padded to 1024


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no host mode")
    return torch.device("cuda")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1024, 50_001])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_kernel_matches_plain(cuda_device, n, p, dtype):
    rng = np.random.default_rng(n + p)
    rows = (rng.normal(size=(n, p)) * 3).astype(np.float32)
    w = (rng.uniform(size=(n,)) + 0.05).astype(np.float32)
    mask = np.ones((n,), np.float32)
    mask[1::3] = 0.0
    trows = torch.from_numpy(rows).to(cuda_device, dtype)
    tw, tm = torch.from_numpy(w).to(cuda_device), torch.from_numpy(mask).to(cuda_device)
    before = (tfed.masked_fedavg_cuda.launches, tfed.fedavg_cuda.launches)
    got_u = tops.fedavg(trows, tw)
    trows[tm == 0] = float("nan")
    got_m = tops.masked_fedavg(trows, tw, tm)
    assert (tfed.masked_fedavg_cuda.launches, tfed.fedavg_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    _close(got_m.cpu(), tfed.masked_fedavg_torch(trows, tw, tm).cpu(), _TOL[dtype])
    _close(got_u.cpu(), tref.fedavg_f64(torch.from_numpy(rows).to(dtype), w), _TOL[dtype])


def _fedavg_edge_inputs(case, dtype, dev):
    """Rows, weights and mask for one of the cases the redesigned kernel opens:
    N past the old 1,024 staging limit (1,100) and past the kernel's 2,048
    staging cap (2,500); a view whose ``data_ptr`` and rows are not 16-byte
    aligned; widths under one 16-byte window; one live row among NaN ones; zero
    weights; the empty mask."""
    shapes = {"n1100": (1100, 777), "n2500": (2500, 333), "unaligned_view": (32, 5001),
              "p1": (7, 1), "p3": (7, 3), "p5": (7, 5), "one_live": (32, 4099),
              "zero_weights": (7, 5003), "empty_mask": (7, 5003)}
    n, p = shapes[case]
    rng = np.random.default_rng(sorted(shapes).index(case))
    rows = torch.from_numpy((rng.normal(size=(n, p)) * 3).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.uniform(size=(n,)) + 0.05).astype(np.float32)).to(dev)
    m = torch.ones((n,), device=dev)
    m[1::3] = 0.0
    if case == "unaligned_view":
        rows = rows[:, 1:]
        assert rows.data_ptr() % 16 and (rows.stride(0) * rows.element_size()) % 16
    elif case == "one_live":
        m = torch.zeros((n,), device=dev)
        m[13] = 1.0
    elif case == "zero_weights":
        w = torch.zeros((n,), device=dev)
    elif case == "empty_mask":
        m = torch.zeros((n,), device=dev)
    rows[m == 0] = float("nan")
    return rows, w, m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["n1100", "n2500", "unaligned_view", "p1", "p3", "p5",
                                  "one_live", "zero_weights", "empty_mask"])
def test_fedavg_kernel_edge_cases(cuda_device, case, dtype):
    rows, w, m = _fedavg_edge_inputs(case, dtype, cuda_device)
    tol = _TOL[dtype]
    got = tops.masked_fedavg(rows, w, m)
    again = tops.masked_fedavg(rows, w, m)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))  # no atomics
    want = tfed.masked_fedavg_torch(rows, w, m)
    assert torch.isfinite(got).all()
    _close(got.cpu(), want.cpu(), tol)
    if case == "empty_mask":
        assert torch.count_nonzero(got) == 0
    if case == "zero_weights":  # uniform over the valid rows
        _close(got.cpu(), rows.float()[m > 0].mean(0).cpu(), tol)
    clean = torch.nan_to_num(rows, nan=0.5)
    got_u = tops.fedavg(clean, w)
    again_u = tops.fedavg(clean, w)
    assert torch.equal(got_u.view(torch.int32), again_u.view(torch.int32))
    _close(got_u.cpu(), tfed.fedavg_torch(clean, w).cpu(), tol)




@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [P_STACK, P_MAIN])
@pytest.mark.parametrize("n", [1, 7, 32, 64])
def test_fedavg_kernel_at_full_width(cuda_device, n, p, dtype):
    """The shapes ``chip_smoke.py`` checks at full width: every block walks
    several tiles round the ring, and at N = 64 the f32 arena passes 2^31
    bytes, so row offsets need 64-bit arithmetic."""
    gen = torch.Generator(device=cuda_device).manual_seed(n * 7 + p % 97)
    rows = (torch.randn((n, p), generator=gen, device=cuda_device) * 3).to(dtype)
    w = torch.rand((n,), generator=gen, device=cuda_device) + 0.05
    plan = tfed.launch_plan(rows)
    assert plan.n_tiles > plan.grid  # at least two tiles for some block
    got_u = tops.fedavg(rows, w)
    _close(got_u.cpu(), tfed.fedavg_torch(rows, w).cpu(), _TOL[dtype])
    m = torch.ones((n,), device=cuda_device)
    m[1::3] = 0.0
    rows[m == 0] = float("nan")
    got = tops.masked_fedavg(rows, w, m)
    again = tops.masked_fedavg(rows, w, m)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _close(got.cpu(), tfed.masked_fedavg_torch(rows, w, m).cpu(), _TOL[dtype])


def test_fedavg_wrappers_launch_one_device_kernel(cuda_device):
    """Each wrapper call is one device kernel, the normalization inside it."""
    from torch.profiler import ProfilerActivity, profile

    rows = torch.randn((32, 70_001), device=cuda_device)
    w = torch.rand((32,), device=cuda_device) + 0.05
    m = torch.ones((32,), device=cuda_device)
    for call in (lambda: tfed.masked_fedavg_cuda(rows, w, m), lambda: tfed.fedavg_cuda(rows, w)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 5 and all("fedavg_kernel" in k for k in names), names


def test_sync_rounds_launch_the_kernel(cuda_device):
    rounds = 2
    _, learners = train.build_housing_learners("100k", 3, 0, device=cuda_device)
    init = mlp.init_params(torch.Generator().manual_seed(0), housing_mlp.reduced(), cuda_device)
    driver = Driver(FederationEnv(protocol="sync", local_steps=2, batch_size=16,
                                  termination=TerminationCriteria(max_rounds=rounds),
                                  device=cuda_device))
    driver.initialize(init, learners)
    before = tfed.masked_fedavg_cuda.launches
    history = driver.run()
    assert tfed.masked_fedavg_cuda.launches - before == rounds
    assert driver.controller.arena.buffer.device.type == "cuda"
    assert all(np.isfinite(h.metrics["eval_loss"]) for h in history)


def _special(size, group, seed):
    """Normal data plus groups of NaN, ±inf, zeros and subnormals."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=size) * 5).astype(np.float32)
    x[:group] = 0.0
    x[group: 2 * group] = (rng.normal(size=group) * 1e-39).astype(np.float32)
    x[2 * group + 3] = np.nan
    x[3 * group + 5] = np.inf
    x[4 * group + 7] = -np.inf
    x[5 * group: 6 * group] = (rng.normal(size=group) * 1e-37).astype(np.float32)
    return x


@pytest.mark.parametrize("group", [256, 512])
@pytest.mark.parametrize("size", [16_384, 100_000, 100_225, 100_001, 100_007, P_STACK])
def test_quantize_kernels_match_plain(cuda_device, size, group):
    """``ops.quantize`` reads the unpadded row (a last group of 129 at
    100,225, tails at 1 and 7 mod 8) and writes the wire's layout in one
    launch, bit-identical to padding then quantizing."""
    x = torch.from_numpy(_special(size, group, seed=size)).to(cuda_device)
    before = (tquant.quantize_cuda.launches, tquant.dequantize_cuda.launches)
    q, s = tops.quantize(x, group=group)
    assert tquant.quantize_cuda.launches == before[0] + 1
    assert s.data_ptr() == q.data_ptr() + q.shape[0]  # one buffer, the wire's layout
    padded = torch.nn.functional.pad(x, (0, q.shape[0] - size))
    pq, ps = tquant.quantize_torch(padded, group)
    assert torch.equal(q, pq)
    assert torch.equal(s.view(torch.int32), ps.view(torch.int32))
    back = tops.dequantize(q, s, size, group=group)
    want = tquant.dequantize_torch(q, s, group)[:size]
    assert torch.equal(back.view(torch.int32), want.view(torch.int32))
    assert (tquant.quantize_cuda.launches, tquant.dequantize_cuda.launches) == (
        before[0] + 1, before[1] + 1)


def _dequantize_agrees(n, group, seed, device):
    """``dequantize_cuda`` bit-identical to ``dequantize_torch``, one launch."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-127, 128, size=n, dtype=np.int8)).to(device)
    s = torch.from_numpy((rng.random(n // group) * 5 + 1e-3).astype(np.float32)).to(device)
    before = tquant.dequantize_cuda.launches
    got = tquant.dequantize_cuda(q, s, group)
    assert tquant.dequantize_cuda.launches == before + 1
    want = tquant.dequantize_torch(q, s, group)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n,group", [(8, 8), (24, 8), (8 * 4_097, 8), (8 * 1_700_001, 8),
                                     (24, 24), (24 * 560_001, 24), (4096, 4096),
                                     (4096 * 3_301, 4096)])
def test_dequantize_kernel_groups(cuda_device, n, group):
    """The persistent grid with odd group counts of group 8 (a row ending
    on half a 16-value unit), group 24 (not a power of two) and 4096, on
    rows of one round and of two (the group carried across the stride)."""
    _dequantize_agrees(n, group, seed=n + group, device=cuda_device)


@pytest.mark.parametrize("delta,group", [(0, 256), (-16, 8), (16, 8)])
def test_dequantize_kernel_at_one_grid_stride(cuda_device, delta, group):
    """A row of exactly one stride of the plan's grid at the 10m row (every
    warp one chunk), and that stride -+ one 16-value unit (the last chunk
    short, left to the tail warp; one unit past the stride)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    stride = tquant.dequant_plan(P_MAIN, sms) * tquant.DQ_WARPS * tquant.DQ_CHUNK
    _dequantize_agrees(stride + delta, group, seed=stride + delta, device=cuda_device)


@pytest.mark.parametrize("n,p,group", [(7, 4096, 256), (33, 2304, 256), (4, 4096, 512)])
def test_fused_q8_kernel_matches_plain(cuda_device, n, p, group):
    rng = np.random.default_rng(n + p)
    q = torch.from_numpy(rng.integers(-127, 128, size=(n, p), dtype=np.int8)).to(cuda_device)
    s = torch.from_numpy(rng.uniform(0.01, 5, size=(n, p // group)).astype(np.float32))
    s = s.to(cuda_device)
    w = torch.from_numpy(rng.uniform(1, 50, size=n).astype(np.float32)).to(cuda_device)
    m = torch.ones((n,), device=cuda_device)
    m[1::3] = 0.0
    s[m == 0] = float("nan")  # a dead row's garbage must not leak
    before = tfused.masked_fedavg_q8_cuda.launches
    got = tops.masked_fedavg_q8(q, s, w, m, group=group)
    assert tfused.masked_fedavg_q8_cuda.launches == before + 1
    assert torch.isfinite(got).all()
    want = tfused.masked_fedavg_q8_torch(q, s, w, m, group)
    _close(got.cpu(), want.cpu(), 2e-5)
    empty = tops.masked_fedavg_q8(q, s, w, torch.zeros_like(m), group=group)
    assert torch.count_nonzero(empty) == 0


def _q8_rows(n, p, group, seed, device):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-127, 128, size=(n, p), dtype=np.int8)).to(device)
    s = torch.from_numpy(rng.uniform(0.01, 5, size=(n, p // group)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(1, 50, size=n).astype(np.float32)).to(device)
    return q, s.to(device), w


def _fedbuff_weights(n, live, seed, device):
    """A FedBuff aggregate's mask (``live`` rows of ``n``) and its staleness
    weights, ``n_i · (1 + s_i)^(-1/2)``."""
    rng = np.random.default_rng(seed)
    m = torch.zeros((n,), device=device)
    m[torch.from_numpy(rng.choice(n, size=live, replace=False))] = 1.0
    examples = torch.from_numpy(rng.integers(50, 150, size=n).astype(np.float32))
    staleness = torch.from_numpy(rng.integers(0, 8, size=n).astype(np.float32))
    return tagg.staleness_weights(examples, staleness).to(device), m


def _q8_agrees(q, s, w, m, group, what):
    """The fused kernel against its plain version (2e-5), bit for bit against
    the f32 FedAvg kernel on the dequantized rows and against a second
    launch; dead rows then filled with NaN and 1e30 scales and saturated
    values change no bit.  Prints and returns the worst error."""
    got = tfused.masked_fedavg_q8_cuda(q, s, w, m, group)
    assert torch.equal(got.view(torch.int32),
                       tfused.masked_fedavg_q8_cuda(q, s, w, m, group).view(torch.int32))
    f32 = tfed.masked_fedavg_cuda(tfused.dequant_rows(q, s, group), w, m)
    assert torch.equal(got.view(torch.int32), f32.view(torch.int32))
    want = tfused.masked_fedavg_q8_torch(q, s, w, m, group)
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    print(f"{what}: max abs err {err} against the plain version (bar 2e-5)")
    _close(got.cpu(), want.cpu(), 2e-5)
    dead = m <= 0
    if bool(dead.any()):
        s[dead] = float("nan")
        s[torch.nonzero(dead).flatten()[::2]] = 1e30
        q[dead] = 127
        garbage = tfused.masked_fedavg_q8_cuda(q, s, w, m, group)
        assert torch.equal(got.view(torch.int32), garbage.view(torch.int32))
    return err


@pytest.mark.parametrize("mask", ["all_live", "fedbuff_8_of_32"])
def test_fused_q8_kernel_at_full_width(cuda_device, mask):
    """The int8_arena leg's (32, 10,174,464) arena with all rows live, and the
    buffered_async_int8 leg's aggregate: 8 of 32 live under staleness
    weights; every block walks several 16 KB tiles round the ring."""
    q, s, w = _q8_rows(32, P_MAIN, 256, seed=17, device=cuda_device)
    m = torch.ones((32,), device=cuda_device)
    if mask == "fedbuff_8_of_32":
        w, m = _fedbuff_weights(32, 8, seed=3, device=cuda_device)
    plan = tfed.launch_plan(q, group=256)
    assert plan.n_tiles > plan.grid
    _q8_agrees(q, s, w, m, 256, f"masked_fedavg_q8 {mask}")


@pytest.mark.parametrize("case", ["group512", "n2049", "zero_weights", "empty_mask",
                                  "unaligned_view", "half_unit_group8", "past_2gb"])
def test_fused_q8_kernel_edge_cases(cuda_device, case):
    """Group 512; past the 2,048-row staging cap (ballots); zero weights (the
    uniform mean over live rows) and the empty mask (zeros); values and
    scales at unaligned offsets and strides; P ≡ 8 (mod 16) at group 8; and a
    strided view of a 2.24 GB arena whose last row starts past 2^31 bytes."""
    dev = cuda_device
    n, p, group = {"group512": (7, 50_176, 512), "n2049": (2049, 2048, 256),
                   "zero_weights": (7, 4608, 256), "empty_mask": (7, 4608, 256),
                   "unaligned_view": (33, 40_960, 256), "half_unit_group8": (5, 8200, 8),
                   "past_2gb": (220, P_MAIN, 256)}[case]
    q, s, w = _q8_rows(n, p + 3, group, seed=n + p, device=dev) if case == "unaligned_view" \
        else _q8_rows(n, p, group, seed=n + p, device=dev)
    m = torch.ones((n,), device=dev)
    m[1::3] = 0.0
    if case == "unaligned_view":  # rows 3 bytes in and p + 3 apart; scales 4 bytes in
        q = q[:, 3:]
        s = torch.cat([s, s[:, :1]], 1)[:, 1:p // group + 1]
        assert q.data_ptr() % 16 and q.stride(0) % 16 and s.data_ptr() % 16
    elif case == "past_2gb":  # rows 0, 73, 146 and 219 of the arena
        q, s, w, m = q[::73], s[::73], w[::73], m[::73]
        assert q.stride(0) * 3 > 2**31
    elif case == "zero_weights":
        w = torch.zeros((n,), device=dev)
    elif case == "empty_mask":
        m = torch.zeros((n,), device=dev)
    got = tfused.masked_fedavg_q8_cuda(q, s, w, m, group)
    if case == "zero_weights":
        _close(got.cpu(), tfused.dequant_rows(q, s, group)[m > 0].mean(0).cpu(), 2e-5)
    elif case == "empty_mask":
        assert torch.count_nonzero(got) == 0
    _q8_agrees(q, s, w, m, group, f"masked_fedavg_q8 {case}")


def test_fused_q8_wrapper_launches_one_device_kernel(cuda_device):
    """The fused wrapper is one device kernel a call, the normalization inside
    it (the profiler misses a record now and then: see below)."""
    from torch.profiler import ProfilerActivity, profile

    q, s, w = _q8_rows(32, 70_144, 256, seed=5, device=cuda_device)
    m = torch.ones((32,), device=cuda_device)
    m[::4] = 0.0
    call = lambda: tfused.masked_fedavg_q8_cuda(q, s, w, m)  # noqa: E731
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= 10:
            break
    assert 9 <= len(names) <= 10 and all("fedavg_kernel" in k for k in names), names


def test_int8_arena_rounds_launch_the_fused_kernel(cuda_device):
    rounds, n_learners = 2, 3
    _, learners = train.build_housing_learners("100k", n_learners, 0, device=cuda_device)
    init = mlp.init_params(torch.Generator().manual_seed(0), housing_mlp.reduced(), cuda_device)
    driver = Driver(FederationEnv(protocol="sync", local_steps=2, batch_size=16,
                                  upload_codec="int8", arena_dtype="int8",
                                  termination=TerminationCriteria(max_rounds=rounds),
                                  device=cuda_device))
    driver.initialize(init, learners)
    before = (tfused.masked_fedavg_q8_cuda.launches, tquant.quantize_cuda.launches)
    history = driver.run()
    assert tfused.masked_fedavg_q8_cuda.launches - before[0] == rounds
    assert tquant.quantize_cuda.launches - before[1] == rounds * n_learners
    arena = driver.controller.arena
    assert arena.buffer.device.type == "cuda" and arena.buffer.dtype == torch.int8
    assert driver.controller.telemetry.value("engine.uploads.quantized_direct") == (
        rounds * n_learners)
    assert all(np.isfinite(h.metrics["eval_loss"]) for h in history)


def _trimmed_inputs(n, p, seed, device, dead=True):
    """Normal rows (a third of them dead, holding NaN and 1e30), duplicated
    and negated rows, a block of all-equal columns and a ±0 column: the
    kernel's ties and garbage.  Made on the card, so full width is quick."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = torch.randn((n, p), generator=gen, device=device) * 3
    if n >= 4:
        rows[n // 2] = rows[0]
        rows[n // 2 + 1] = -rows[1]
    rows[:, : p // 8] = 0.5
    rows[::2, p // 8] = 0.0
    rows[1::2, p // 8] = -0.0
    mask = torch.ones((n,), device=device)
    if dead:
        mask[2::3] = 0.0
        rows[2::3] = float("nan")
        rows[5::6] = 1e30
    return rows, mask


# N on both sides of each of the network's template sizes (4, 8, 16, 32, 64)
# and of the switch to the rank-select past 64, with trim_k at 0 or 1,
# middling and 2·trim_k = N − 1; then full width at N = 32 and 64, where
# the row offsets pass 2^31 bytes.
_TRIMMED_CASES = [
    (n, trim_k, p)
    for p in (1024, 5000)
    for n, trim_k in ((3, 0), (3, 1), (8, 3), (33, 8), (64, 31), (2001, 1000), (2, 0), (4, 1),
                      (5, 2), (16, 7), (17, 8), (31, 15), (32, 1), (63, 31), (65, 32), (65, 1))
] + [(32, 8, P_MAIN), (64, 16, P_MAIN), (64, 1, P_MAIN)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,trim_k,p", _TRIMMED_CASES)
def test_trimmed_mean_kernel_matches_plain(cuda_device, n, trim_k, p, dtype):
    for dead in (False, True):
        rows, tm = _trimmed_inputs(n, p, seed=n + p + trim_k, device=cuda_device, dead=dead)
        trows = rows.to(dtype)
        before = trobust.masked_trimmed_mean_cuda.launches
        got = tops.masked_trimmed_mean(trows, torch.ones_like(tm), tm, trim_k=trim_k)
        torch.cuda.synchronize()
        assert trobust.masked_trimmed_mean_cuda.launches == before + 1
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        want = trobust.masked_trimmed_mean_torch(trows, tm, trim_k)
        _close(got.cpu(), want.cpu(), 1e-5)
        if p < P_MAIN:  # the host f64 sort of a full-width arena takes too long
            oracle = tref.masked_trimmed_mean_f64(trows.float().cpu(), tm.cpu(), trim_k)
            _close(got.cpu(), oracle, 1e-5)
        del rows, trows


def test_trimmed_mean_kernel_edges(cuda_device):
    trows, _ = _trimmed_inputs(8, 3000, seed=1, device=cuda_device)
    none = tops.masked_trimmed_mean(trows, torch.ones(8), torch.zeros(8, device=cuda_device), 2)
    assert torch.count_nonzero(none) == 0
    two = torch.zeros(8, device=cuda_device)
    two[[0, 4]] = 1.0  # degenerate cohort: the untrimmed mean of rows 0 and 4
    got = tops.masked_trimmed_mean(trows, torch.ones(8), two, trim_k=2)
    _close(got.cpu(), ((trows[0] + trows[4]) / 2.0).cpu(), 1e-5)
    with pytest.raises(ValueError, match="trim_k=4 invalid for N=8"):
        trobust.masked_trimmed_mean_cuda(trows, torch.ones(8, device=cuda_device), 4)
    padded = torch.zeros((8, 4096), device=cuda_device)
    padded[:, :3000] = trows  # the arena's padded width, read in place
    got = tops.masked_trimmed_mean(padded[:, :3000], torch.ones(8),
                                   torch.ones(8, device=cuda_device), trim_k=1)
    want = trobust.masked_trimmed_mean_torch(trows, torch.ones(8, device=cuda_device), 1)
    _close(got.cpu(), want.cpu(), 1e-5)


@pytest.mark.parametrize("n,trim_k", [(8, 1), (8, 3), (5, 2), (33, 8), (64, 31)])
def test_trimmed_mean_kernel_nan_in_live_rows(cuda_device, n, trim_k):
    """A NaN in a live row (x86's negative NaN too) and +inf meeting -inf:
    the kernel agrees with the sort, which puts NaN of either sign last, on
    the band and on the degenerate fallback alike.  It is held against the
    plain version on the host: ``torch.sort`` on the card puts a negative NaN
    first."""
    rows, _ = _trimmed_inputs(n, 3000, seed=n + trim_k, device=cuda_device, dead=False)
    rows[2::3] = float("nan")
    rows[4::5] = -float("nan")
    rows[1, :500] = float("inf")
    rows[3, 300:900] = -float("inf")
    for mask in (torch.ones(n, device=cuda_device),
                 (torch.arange(n, device=cuda_device) % 4 != 3).float()):
        got = trobust.masked_trimmed_mean_cuda(rows, mask, trim_k).cpu()
        want = trobust.masked_trimmed_mean_torch(rows.cpu(), mask.cpu(), trim_k)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        both = ~torch.isnan(want)
        _close(got[both], want[both], 1e-5)


def test_quantize_and_trimmed_mean_launch_one_device_kernel(cuda_device):
    """``ops.quantize`` on the unpadded row and the trimmed mean are each one
    device kernel a call (no pad, no copy, no torch op).  The profiler must
    have recorded them, so the test cannot pass on an empty trace.  It has
    been seen to miss a record now and then, and a whole window once, never
    to add one; so a window is traced up to three times, the fullest is kept
    (as ``chip_smoke._count_device_kernels`` keeps it), and one missed record
    of ten is accepted."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((P_STACK,), device=cuda_device)
    rows = torch.randn((32, 70_001), device=cuda_device)
    m = torch.ones((32,), device=cuda_device)
    for call, kernel in ((lambda: tops.quantize(x), "quantize_kernel"),
                         (lambda: trobust.masked_trimmed_mean_cuda(rows, m, 8), "network_kernel")):
        call()
        torch.cuda.synchronize()
        names: list[str] = []
        for _ in range(3):  # a window that missed a record is traced again
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            seen = [e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            if len(seen) > len(names):
                names = seen
            if len(names) >= 10:
                break
        assert 9 <= len(names) <= 10 and all(kernel in k for k in names), names


def test_trimmed_mean_rounds_launch_the_kernel(cuda_device):
    rounds = 2
    _, learners = train.build_housing_learners("100k", 5, 0, device=cuda_device)
    init = mlp.init_params(torch.Generator().manual_seed(0), housing_mlp.reduced(), cuda_device)
    driver = Driver(FederationEnv(protocol="sync", local_steps=2, batch_size=16,
                                  aggregation_rule="trimmed_mean", trim_k=2,
                                  termination=TerminationCriteria(max_rounds=rounds),
                                  device=cuda_device))
    driver.initialize(init, learners)
    before = (trobust.masked_trimmed_mean_cuda.launches, tfed.masked_fedavg_cuda.launches)
    history = driver.run()
    assert trobust.masked_trimmed_mean_cuda.launches - before[0] == rounds
    assert tfed.masked_fedavg_cuda.launches == before[1]
    assert all(np.isfinite(h.metrics["eval_loss"]) for h in history)


_NEG_NAN = float(np.array([0xFFC00000], np.uint32).view(np.float32)[0])  # sign bit set


def _nan_rows(n, p, seed):
    """Integer-valued rows (every sum exact in any order) with a negative and a
    positive NaN in live rows, and NaN in the dead row 0."""
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(rng.integers(-50, 50, size=(n, p)).astype(np.float32))
    rows[2, ::3] = _NEG_NAN
    rows[5, 1::4] = float("nan")
    rows[7, ::7] = _NEG_NAN
    rows[0] = _NEG_NAN
    mask = torch.ones(n)
    mask[0] = 0.0
    return rows, mask


_ROBUST_SORTS = {
    # n = 9 rows, row 0 dead: 8 live, so trim_k 2 leaves a band of 4 and
    # every mean divides by a power of two (the card multiplies by 1/count)
    "masked_coordinate_median": lambda r, m: tagg.masked_coordinate_median(r, m, m),
    "masked_trimmed_mean_torch": lambda r, m: trobust.masked_trimmed_mean_torch(r, m, 2),
    "trimmed_mean": lambda r, m: tagg.trimmed_mean(r[1:], 2),
    "coordinate_median": lambda r, m: tagg.coordinate_median(r[1:]),
}


@pytest.mark.parametrize("name", sorted(_ROBUST_SORTS))
def test_robust_sorts_put_every_nan_last_on_the_card(cuda_device, name):
    """``torch.sort`` on the card puts a negative NaN first; each robust sort
    makes NaN positive first, so the card's result equals the host's bit for
    bit.  NaN results are compared as NaN: the card's arithmetic returns its
    own NaN payload."""
    rows, mask = _nan_rows(9, 4099, seed=3)
    fn = _ROBUST_SORTS[name]
    want = fn(rows, mask)
    got = fn(rows.to(cuda_device), mask.to(cuda_device)).cpu()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _secure_inputs(n, p, seed):
    """Normal rows, specials (NaN of both signs, ±inf, values past ±2^31 once
    scaled, halves of the fixed-point step) in the first, and a block whose
    weighted mean passes 2^31 once encoded, so the int32 sum wraps."""
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(n, p)) * 100).astype(np.float32)
    rows[0, :12] = [np.nan, -np.nan, np.inf, -np.inf, 32768.0, -32768.0, 1e30, -1e30,
                    0.5 / 65536, 1.5 / 65536, 2.5 / 65536, -2.5 / 65536]
    rows[:, 100:200] = 40000.0 - rng.random((n, 100)).astype(np.float32)
    rows[1, 100:200:3] *= -1
    return rows


@pytest.mark.parametrize("n,p", [(2, 1000), (5, 4099), (32, 65_536)])
def test_secure_sum_and_encode_on_the_card_match_the_host(cuda_device, n, p):
    rows = _secure_inputs(n, p, seed=n)
    weights = [float(i % 7 + 1) for i in range(n)]
    host = torch.from_numpy(rows)
    card = host.to(cuda_device)
    for r in range(n):
        assert torch.equal(tsec.encode_fixed(card[r]).cpu(), tsec.encode_fixed(host[r]))
    got = tsec.secure_fedavg_arena(card, list(range(n)), weights, base_seed=n).cpu()
    want = tsec.secure_fedavg_arena(host, list(range(n)), weights, base_seed=n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the pads cancel: the result is the unmasked wrapping sum, decoded
    wsum = float(sum(weights))
    total = torch.zeros(p, dtype=torch.int64)
    for r in range(n):
        enc = tsec.encode_fixed(host[r] * float(np.float32(weights[r] / wsum)))
        total = (total + enc.to(torch.int64)) % (1 << 32)
    plain = torch.where(total >= 1 << 31, total - (1 << 32), total).to(torch.int32)
    assert bool((plain[100:200] < 0).any())  # the block wrapped
    assert torch.equal(got.view(torch.int32),
                       tsec.decode_fixed(plain).view(torch.int32))
    # a single masked upload is the card's own: it differs from the host's
    masker = tsec.PairwiseMasker(base_seed=n, participants=tuple(range(n)))
    on_card = tsec.mask_upload(masker, 0, card[0]).cpu()
    on_host = tsec.mask_upload(masker, 0, host[0])
    assert float((on_card == on_host).float().mean()) < 0.01


def test_secure_pads_set_the_sign_bit_in_half_the_draws(cuda_device):
    pad = tsec.PairwiseMasker(base_seed=3, participants=tuple(range(4))).net_mask(
        1, 1 << 22, device=cuda_device)
    assert pad.device.type == "cuda" and pad.dtype == torch.int32
    assert 0.499 < float((pad < 0).float().mean()) < 0.501


@pytest.mark.parametrize("arena_dtype", ["f32", "int8"])
def test_arena_checkpoint_round_trip_at_full_width(cuda_device, arena_dtype, tmp_path):
    n = 32
    src = ArenaStore(num_params=10_174_081, n_max=n, arena_dtype=arena_dtype,
                     device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for i in range(n):
        row = torch.randn((src.padded_params,), generator=gen, device=cuda_device) * 3
        src.write(f"learner_{i:03d}", row, weight=float(i + 1), version=float(i % 3))
    src.invalidate("learner_007")
    state = src.export_state()
    path = tmp_path / "arena.npz"
    np.savez(path, **{k: v for k, v in state.items() if k != "rows"})
    dst = ArenaStore(num_params=10_174_081, n_max=4, arena_dtype=arena_dtype,
                     device=cuda_device)
    with np.load(path) as z:
        dst.restore_state(rows=state["rows"], **{k: z[k] for k in z.files})
    assert dst.buffer.device.type == "cuda" and dst.buffer.dtype == src.buffer.dtype
    assert torch.equal(dst.buffer.view(torch.uint8), src.buffer.view(torch.uint8))
    if arena_dtype == "int8":
        assert torch.equal(dst.scales.view(torch.int32), src.scales.view(torch.int32))
    for name in ("weights", "versions", "mask"):
        assert torch.equal(getattr(dst, name), getattr(src, name)), name
    assert dst.valid_ids() == src.valid_ids() and "learner_007" not in dst


# -- the top-k uplink -----------------------------------------------------------

K_MAIN = P_MAIN // 64  # 158,976: the reference's k = P/64


def _special_row(n: int, seed: int) -> np.ndarray:
    """Seeded f32 row with planted magnitude ties, ±0, ±inf and a negative
    (0xFFC00000) and a positive NaN."""
    rng = np.random.default_rng(seed)
    row = (rng.normal(size=n) * 3).astype(np.float32)
    pick = rng.choice(n, size=4096, replace=False)
    row[pick[:2000]] = np.float32(row[pick[0]]) * np.where(np.arange(2000) % 2, 1, -1)
    row[pick[2000]], row[pick[2001]] = 0.0, -0.0
    row[pick[2002]] = np.uint32(0xFFC00000).view(np.float32)
    row[pick[2003]] = np.nan
    row[pick[2004]], row[pick[2005]] = np.inf, -np.inf
    row[pick[2006:]] = np.round(row[pick[2006:]] * 4) / 4  # more ties
    return row


@pytest.mark.parametrize("value_dtype", ["f32", "int8"])
def test_topk_encode_at_full_width_equals_the_host(cuda_device, value_dtype):
    row = torch.from_numpy(_special_row(P_MAIN, 0))
    codec = ttransport.TopkUploadCodec(k=K_MAIN, value_dtype=value_dtype)
    on_card = codec.encode(row.to(cuda_device))
    on_host = codec.encode(row)
    assert on_card.nbytes == codec.wire_nbytes(P_MAIN)
    assert np.array_equal(on_card, on_host)


@pytest.mark.parametrize("n,k", [(9, 6), (4096, 100), (1_000_003, 4096)])
def test_topk_select_densify_residual_on_the_card(cuda_device, n, k):
    row = _special_row(max(n, 8192), n)[:n] if n > 9 else np.array(
        [1, -3, np.nan, 3, np.uint32(0xFFC00000).view(np.float32), 0, -0.0, 2, np.inf],
        np.float32)
    host = torch.from_numpy(row)
    idx_h, val_h = ttopk.topk_select(host, k)
    idx_c, val_c = ttopk.topk_select(host.to(cuda_device), k)
    assert torch.equal(idx_c.cpu(), idx_h)
    assert torch.equal(val_c.cpu().view(torch.int32), val_h.view(torch.int32))
    if n == 9:
        assert idx_h.tolist() == [2, 4, 8, 1, 3, 7]
    # Arithmetic on a NaN returns the card's own NaN (0x7FFFFFFF), not the
    # operand's payload: NaN results are compared as NaN, the rest by bits.
    acc = torch.from_numpy((np.random.default_rng(n).normal(size=n) * 2).astype(np.float32))
    for got, want in ((ttopk.densify(idx_c, val_c, n), ttopk.densify(idx_h, val_h, n)),
                      (ttopk.ef_residual(acc.to(cuda_device), idx_c, val_c),
                       ttopk.ef_residual(acc, idx_h, val_h))):
        got = got.cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        keep = ~torch.isnan(want)
        assert torch.equal(got[keep].view(torch.int32), want[keep].view(torch.int32))


def _sparse_arena(n: int, k: int, width: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    idx = torch.stack([torch.randperm(width, generator=gen)[:k] for _ in range(n)])
    val = torch.randn((n, k), generator=gen) * 2
    w = torch.rand((n,), generator=gen) * 10 + 1
    mask = torch.ones((n,))
    mask[3] = 0.0
    val[3] = float("nan")
    return idx.to(torch.int32), val, w, mask


def test_scatter_accumulate_is_bit_stable_on_the_card(cuda_device):
    idx, val, w, mask = _sparse_arena(32, K_MAIN, P_MAIN, 0)
    wn = w * mask / (w * mask).sum()
    args = [t.to(cuda_device) for t in (idx, val, wn, mask)]
    first = tsparse.scatter_accumulate(*args, P_MAIN)
    second = tsparse.scatter_accumulate(*args, P_MAIN)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    host = tsparse.scatter_accumulate(idx, val, wn, mask, P_MAIN)
    np.testing.assert_allclose(first.cpu().numpy(), host.numpy(), rtol=1e-6, atol=0)
    assert torch.isfinite(first).all()


def test_sparse_arena_checkpoint_round_trip_at_full_width(cuda_device, tmp_path):
    n = 32
    src = ArenaStore(num_params=10_174_081, n_max=n, arena_dtype="topk", sparse_k=K_MAIN,
                     device=cuda_device)
    idx, val, _, _ = _sparse_arena(n, K_MAIN, P_MAIN, 1)
    for i in range(n):
        src.write_sparse(f"learner_{i:03d}", idx[i].to(cuda_device), val[i].to(cuda_device),
                         weight=float(i + 1), version=float(i % 3))
    src.invalidate("learner_007")
    state = src.export_state()
    path = tmp_path / "arena.npz"
    np.savez(path, **{k: v for k, v in state.items() if k != "rows"})
    dst = ArenaStore(num_params=10_174_081, n_max=4, arena_dtype="topk", sparse_k=K_MAIN,
                     device=cuda_device)
    with np.load(path) as z:
        dst.restore_state(rows=state["rows"], **{k: z[k] for k in z.files})
    assert dst.indices.device.type == "cuda" and dst.indices.dtype == torch.int32
    assert torch.equal(dst.indices, src.indices)
    assert torch.equal(dst.buffer.view(torch.int32), src.buffer.view(torch.int32))
    for name in ("weights", "versions", "mask"):
        assert torch.equal(getattr(dst, name), getattr(src, name)), name
    assert dst.valid_ids() == src.valid_ids() and "learner_007" not in dst
    assert dst.resident_bytes() == src.resident_bytes() == n * K_MAIN * 8 + 3 * n * 4
    for lid in ("learner_003", "learner_004"):  # row 3 holds NaN values
        assert torch.equal(dst.row_view(lid).view(torch.int32), src.row_view(lid).view(torch.int32))


def _lm_mask(device):
    m = torch.ones((32,), device=device)
    m[1::3] = 0.0
    return m


def test_fedavg_kernel_at_the_lm_arena(cuda_device):
    """fedlm-100m's (32, 73,937,920) f32 arena: 2.37e9 elements, past 2^31,
    every third row dead and NaN; two launches bit-identical."""
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    rows = torch.randn((32, P_LM), generator=gen, device=cuda_device)
    w = torch.rand((32,), generator=gen, device=cuda_device) + 0.05
    m = _lm_mask(cuda_device)
    rows[m == 0] = float("nan")
    got = tops.masked_fedavg(rows, w, m)
    again = tops.masked_fedavg(rows, w, m)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = tfed.masked_fedavg_torch(rows, w, m)
    _close(got.cpu(), want.cpu(), 1e-5)


def test_fused_q8_kernel_at_the_lm_arena(cuda_device):
    """fedlm-100m's (32, 73,937,920) int8 arena and (32, 288,820) scales, every
    third row dead, NaN scales and saturated values in the dead rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    q = torch.randint(-127, 128, (32, P_LM), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    s = torch.rand((32, P_LM // 256), generator=gen, device=cuda_device) * 5 + 0.01
    w = torch.rand((32,), generator=gen, device=cuda_device) * 49 + 1
    _q8_agrees(q, s, w, _lm_mask(cuda_device), 256, "masked_fedavg_q8 at the LM arena")


def test_fedlm_100m_forward_on_the_card_matches_the_host(cuda_device):
    full_f32()
    cfg = dataclasses.replace(fedlm_100m.config(), dtype=torch.float32)
    host = transformer.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 64)))
             for k in ("tokens", "labels")}
    card = tree_map(lambda t: t.to(cuda_device), host)
    card_batch = {k: v.to(cuda_device) for k, v in batch.items()}
    with torch.no_grad():
        want = transformer.forward(host, batch["tokens"], cfg)[0]
        got = transformer.forward(card, card_batch["tokens"], cfg)[0]
        want_loss = transformer.lm_loss(host, batch, cfg)
        got_loss = transformer.lm_loss(card, card_batch, cfg)
    V = cfg.vocab_size
    np.testing.assert_allclose(got[..., :V].cpu().numpy(), want[..., :V].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-4, atol=1e-5)


P_MOE = 1_228_025_856  # qwen2-moe-a2.7b at full width, one layer: its arena row


def test_fedavg_kernel_at_the_moe_arena(cuda_device):
    """The lm_moe_arena leg's (4, 1,228,025,856) f32 arena: 4.91e9 elements
    (19.65 GB), past 2^31, one row dead and NaN; two launches bit-identical;
    the plain version at 1e-5."""
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    rows = torch.randn((4, P_MOE), generator=gen, device=cuda_device)
    w = torch.rand((4,), generator=gen, device=cuda_device) + 0.05
    m = torch.tensor([1.0, 0.0, 1.0, 1.0], device=cuda_device)
    rows[1] = float("nan")
    got = tops.masked_fedavg(rows, w, m)
    again = tops.masked_fedavg(rows, w, m)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = tfed.masked_fedavg_torch(rows, w, m)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5 + 1e-5 * float(want.abs().max())


_FAMILIES = ("qwen2-moe-a2.7b", "deepseek-v3-671b", "mamba2-780m", "zamba2-1.2b",
             "whisper-large-v3")


def _family_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 24)))
             for k in ("tokens", "labels")}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(2, cfg.encoder_seq_len, cfg.frontend_dim)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", _FAMILIES)
def test_family_forward_on_the_card_matches_the_host(cuda_device, arch):
    """Each new family's reduced configuration in f32 (TF32 off): logits and
    ``lm_loss`` (the MoE aux and MTP terms in it) on the card against the
    host at rtol 1e-4 / atol 1e-5, on weights from one host seed."""
    from repro_torch.configs import get_reduced

    full_f32()
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    host = transformer.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = _family_inputs(cfg, 1)
    card = tree_map(lambda t: t.to(cuda_device), host)
    card_batch = {k: v.to(cuda_device) for k, v in batch.items()}
    with torch.no_grad():
        want = transformer.forward(host, batch["tokens"], cfg, frames=batch.get("frames"))[0]
        got = transformer.forward(card, card_batch["tokens"], cfg,
                                  frames=card_batch.get("frames"))[0]
        want_loss = transformer.lm_loss(host, batch, cfg)
        got_loss = transformer.lm_loss(card, card_batch, cfg)
    V = cfg.vocab_size
    np.testing.assert_allclose(got[..., :V].cpu().numpy(), want[..., :V].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-4, atol=1e-5)


def _layer_case(name, device):
    """(function, inputs on ``device``) for one layer at a reduced size."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 37, 256), generator=gen)
    if name == "apply_moe_dense":
        cfg = dataclasses.replace(get_reduced("qwen2-moe-a2.7b"), dtype=torch.float32)
        p = layers.init_moe(gen, cfg)
        return (lambda p_, x_: layers.apply_moe_dense(p_, x_, cfg)), (p, x)
    if name == "apply_mla":
        cfg = dataclasses.replace(get_reduced("deepseek-v3-671b"), dtype=torch.float32,
                                  attn_chunk_min_len=16, attn_k_chunk=16)
        p = layers.init_mla(gen, cfg)
        pos = torch.arange(37)[None, :]
        return (lambda p_, x_, pos_: layers.apply_mla(p_, x_, cfg, positions=pos_,
                                                      mode="causal")[0]), (p, x, pos)
    B, S, H, Pd, N = 2, 37, 8, 16, 16
    xh = torch.randn((B, S, H, Pd), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen) - 1.0)
    A = -torch.linspace(1.0, 16.0, H)
    Bm, Cm = torch.randn((B, S, N), generator=gen), torch.randn((B, S, N), generator=gen)
    return (lambda *a: layers._ssd_chunked(*a, 8)), (xh, dt, A, Bm, Cm)


@pytest.mark.parametrize("name", ["apply_moe_dense", "apply_mla", "_ssd_chunked"])
def test_h2_h3_layers_on_the_card_match_the_host(cuda_device, name):
    """The dense MoE (every expert on every token), MLA through the chunked
    attention (37 keys in chunks of 16) and the chunked SSD (37 steps in
    chunks of 8, a padded tail), f32 with TF32 off, card against host at
    rtol 1e-4 and atol 1e-5 of the output's largest magnitude: the
    reference's init draws the stacked experts at σ = 1/sqrt(E) (its
    ``fan_in`` is the leading axis), so the MoE's outputs reach some
    hundreds, and an output near 0 is a difference of such terms."""
    full_f32()
    fn, args = _layer_case(name, "cpu")
    want = fn(*args)
    got = fn(*tree_map(lambda t: t.to(cuda_device), list(args)))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        atol = 1e-5 * max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4, atol=atol)


def test_quantize_kernels_past_2_31_elements(cuda_device):
    """Kernels 3 and 4 on a row of 2^31 + 2^20 + 100 f32 values (the serve
    leg's int8 echo is 3.88e9): bit-identical to their plain versions on the
    first 2^20 values, the 2^21 around element 2^31 and the tail, through the
    encoder's padding and its wire prefix."""
    n = 2 ** 31 + 2 ** 20 + 100
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    row = torch.randn((n,), generator=gen, device=cuda_device) * 3
    n_padded, n_scales, nbytes = tquant.wire_layout(n)
    q, s = tops.quantize(row, block_rows=tquant.effective_block_rows(n))
    assert q.shape[0] == n_padded
    assert tquant.wire_prefix(q, s, n_scales).shape[0] == nbytes
    tail = (n_padded - 2 ** 20) // 256 * 256
    windows = [(0, 2 ** 20), (2 ** 31 - 2 ** 20, 2 ** 31 + 2 ** 20), (tail, n_padded)]
    for a, b in windows:
        pq, ps = tquant.quantize_torch(row[a:min(b, n)], 256, b - a)
        assert torch.equal(q[a:b], pq), (a, b)
        assert torch.equal(s[a // 256:b // 256].view(torch.int32), ps.view(torch.int32)), (a, b)
    del row
    deq = tquant.dequantize_cuda(q, s, 256)
    for a, b in windows:
        want = tquant.dequantize_torch(q[a:b], s[a // 256:b // 256], 256)
        assert torch.equal(deq[a:b].view(torch.int32), want.view(torch.int32)), (a, b)


_DECODE_ARCHS = ("gemma3-4b", "mamba2-780m", "zamba2-1.2b", "deepseek-v3-671b", "qwen3-14b",
                 "whisper-large-v3", "qwen2-moe-a2.7b")


@pytest.mark.parametrize("arch,S", [(a, 12) for a in _DECODE_ARCHS] + [("gemma3-4b", 40)])
def test_decode_on_the_card_matches_the_host(cuda_device, arch, S):
    """Each family's reduced f32 decode (TF32 off), every step's logits on
    the card against the host at rtol 1e-4 / atol 1e-5, into a 16-position
    cache (reduced gemma3 over 40 positions: its 16-slot rings wrap twice);
    the cache written in place on the card."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import kvcache
    from repro_torch.tree import flatten

    full_f32()
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    host = transformer.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    card = tree_map(lambda t: t.to(cuda_device), host)
    batch = _family_inputs(cfg, 4)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, S)))
    logits = {}
    for name, params, dev in (("host", host, torch.device("cpu")), ("card", card, cuda_device)):
        with torch.no_grad():
            mem = (transformer.encode(params, batch["frames"].to(dev), cfg)
                   if cfg.is_encoder_decoder else None)
        caches = kvcache.init_cache(cfg, tokens.shape[0], max(16, S), dtype=torch.float32,
                                    device=dev)
        ptrs = [t.data_ptr() for t in flatten(caches)[0]]
        logits[name] = torch.cat([transformer.decode_step(
            params, tokens[:, t:t + 1].to(dev), caches, t, cfg, memory=mem)[0].cpu()
            for t in range(S)], dim=1)
        assert [t.data_ptr() for t in flatten(caches)[0]] == ptrs
    V = cfg.vocab_size
    np.testing.assert_allclose(logits["card"][..., :V].numpy(), logits["host"][..., :V].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_int8_echo_on_the_card_equals_the_hosts(cuda_device, monkeypatch):
    """``launch/serve.push_to_replicas`` of reduced gemma3 with int8 echoes:
    the same counters on the card and the host, and every echo's wire bytes
    identical (kernel 3 against its plain version through the codec)."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve

    cfg = get_reduced("gemma3-4b")
    host = transformer.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    seen = {"cpu": [], "cuda": []}
    upload = ttransport.Channel.upload

    def spy(self, *args, **kw):
        env = upload(self, *args, **kw)
        seen[self.device.type].append(env.payload.copy())
        return env

    monkeypatch.setattr(ttransport.Channel, "upload", spy)
    before = (tquant.quantize_cuda.launches, tquant.dequantize_cuda.launches)
    ch_card, _, _ = serve.push_to_replicas(tree_map(lambda t: t.to(cuda_device), host), 3,
                                           replica_upload="int8")
    assert (tquant.quantize_cuda.launches - before[0],
            tquant.dequantize_cuda.launches - before[1]) == (3, 1)
    ch_host, _, _ = serve.push_to_replicas(host, 3, replica_upload="int8")
    for name in ("channel.bytes_moved", "channel.upload_bytes", "channel.upload_messages"):
        assert ch_card.telemetry.value(name) == ch_host.telemetry.value(name), name
    assert len(seen["cuda"]) == len(seen["cpu"]) == 3
    for got, want in zip(seen["cuda"], seen["cpu"]):
        assert got.tobytes() == want.tobytes()


# -- the column-sharded arena: 4 slots of one card ----------------------------

SLOTS = 4


def _slot_mesh(dev):
    """``SLOTS`` slots, every one on the card (the one-card layout of
    ``make_controller_mesh(SLOTS)``)."""
    from repro_torch.launch.mesh import SlotMesh

    grid = np.empty((SLOTS,), dtype=object)
    for s in range(SLOTS):
        grid[s] = torch.device("cuda", dev.index or 0)
    return SlotMesh(grid, ("data",))


@pytest.mark.parametrize("kernel", ["masked_fedavg", "masked_fedavg_q8", "masked_trimmed_mean"])
def test_sharded_kernels_equal_one_launch_on_the_whole_arena(cuda_device, kernel):
    """Kernels 1, 5 and 6 once a slot on the 10m arena's four column shards:
    the bits of one launch on the whole arena (a NaN dead row and dead scales),
    one launch a slot."""
    from repro_torch.models.sharding import arena_specs

    mesh = _slot_mesh(cuda_device)
    layout = arena_specs(mesh)[0]
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    n = 32
    m = torch.ones((n,), device=cuda_device)
    m[5] = 0.0
    w = torch.rand((n,), generator=gen, device=cuda_device) + 0.05
    if kernel == "masked_fedavg_q8":
        q = torch.randint(-127, 128, (n, P_MAIN), generator=gen, device=cuda_device,
                          dtype=torch.int8)
        s = torch.rand((n, P_MAIN // 256), generator=gen, device=cuda_device) + 0.01
        s[5] = float("nan")
        wrapper = tfused.masked_fedavg_q8_cuda
        sharded, args = tops.masked_fedavg_q8_sharded(mesh), (layout.split(q), layout.split(s))
        whole = lambda: wrapper(q, s, w, m)  # noqa: E731
    else:
        rows = torch.randn((n, P_MAIN), generator=gen, device=cuda_device)
        rows[5] = float("nan")
        args = (layout.split(rows),)
        if kernel == "masked_fedavg":
            wrapper, sharded = tfed.masked_fedavg_cuda, tops.masked_fedavg_sharded(mesh)
            whole = lambda: wrapper(rows, w, m)  # noqa: E731
        else:
            wrapper = trobust.masked_trimmed_mean_cuda
            sharded = tops.masked_trimmed_mean_sharded(mesh, trim_k=8)
            whole = lambda: wrapper(rows, m, 8)  # noqa: E731
    assert [tuple(a.shape) for a in args[0]] == [(n, P_MAIN // SLOTS)] * SLOTS
    before = wrapper.launches
    got = sharded(*args, w, m)
    assert wrapper.launches - before == SLOTS
    want = whole()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.isfinite(got).all()


def test_sharded_scatter_equals_the_unsharded_on_the_card(cuda_device):
    idx, val, w, mask = _sparse_arena(32, K_MAIN, P_MAIN, 2)
    wn = w * mask / (w * mask).sum()
    args = [t.to(cuda_device) for t in (idx, val, wn, mask)]
    got = tsparse.scatter_accumulate_sharded(_slot_mesh(cuda_device), "data", P_MAIN)(*args)
    want = tsparse.scatter_accumulate(*args, P_MAIN)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_sharded_sync_round_on_the_card_equals_the_unsharded_round(cuda_device):
    """A housing-mlp 100k federation with its arena on 4 slots of the card:
    the unsharded run's global model, bit for bit."""
    out = []
    for shards in (0, SLOTS):
        cfg, learners = train.build_housing_learners("100k", 4, seed=0, device=cuda_device)
        d = Driver(FederationEnv(local_steps=2, batch_size=100, learning_rate=0.01,
                                 termination=TerminationCriteria(max_rounds=2),
                                 arena_shards=shards, max_dispatch_workers=1,
                                 device=cuda_device))
        d.initialize(mlp.init_params(torch.Generator().manual_seed(0), cfg, cuda_device),
                     learners)
        d.run()
        assert d.controller.arena.sharded == bool(shards)
        out.append(d.controller.global_buffer)
    assert torch.equal(out[0].view(torch.int32), out[1].view(torch.int32))


# ---------------------------------------------------------------------------
# the model axis (slice G-2): the per-slot bodies on one card
# ---------------------------------------------------------------------------


def _reduced_f32(arch, **kw):
    from repro_torch.configs import get_reduced

    return dataclasses.replace(get_reduced(arch), dtype=torch.float32, **kw)


def _debug_policy(cfg, shape, dev, **kw):
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.sharding import make_policy

    return make_policy(cfg, make_debug_mesh(*shape, device=dev), **kw)


def test_sharded_gemma3_decode_step_on_the_card_shows_no_memcpy(cuda_device):
    """Reduced gemma3-4b (34 layers) decoding over 8 model slots of the card
    (every layer's ``_flash_decode``: its 16-slot rings and 32-slot global
    caches split 8 ways), the position a device tensor built once: the
    profiler sees device kernels and no memcpy in a step; every step's
    logits equal the host's at rtol 1e-4 / atol 1e-5 (f32, TF32 off); the
    cache written in place."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import kvcache
    from repro_torch.tree import flatten

    full_f32()
    cfg = _reduced_f32("gemma3-4b", n_layers=34)
    host = transformer.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 20)))
    logits = {}
    for name, dev in (("host", torch.device("cpu")), ("card", cuda_device)):
        params = tree_map(lambda t: t.to(dev), host)
        pol = _debug_policy(cfg, (1, 8), dev)
        assert not pol.shard_kv_heads
        cache = kvcache.init_cache(cfg, 4, 32, dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in flatten(cache)[0]]
        pos = [torch.full((), t, dtype=torch.int64, device=dev) for t in range(20)]
        logits[name] = torch.cat([transformer.decode_step(
            params, tokens[:, t:t + 1].to(dev), cache, pos[t], cfg, policy=pol)[0].cpu()
            for t in range(19)], dim=1)
        assert [t.data_ptr() for t in flatten(cache)[0]] == ptrs
    last = tokens[:, -1:].to(cuda_device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        transformer.decode_step(params, last, cache, pos[19], cfg, policy=pol)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and not [n for n in names if "memcpy" in n.lower()], names
    V = cfg.vocab_size
    np.testing.assert_allclose(logits["card"][..., :V].numpy(), logits["host"][..., :V].numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["dispatch_2x2", "dispatch_1x4", "decode_2x4"])
def test_moe_ep_on_the_card_matches_the_host(cuda_device, case):
    """``apply_moe_ep`` on slots of the card against the host: the dispatch
    body over (2, 2) and (1, 4) on reduced qwen2-moe with 8 experts (capacity
    drops routes: the same kept routes), the weights-stationary 2-D decode
    body over (2, 4) with FSDP and serving; output at rtol 1e-4 / atol 1e-5
    of its largest value, the aux loss at 1e-5, f32 with TF32 off."""
    from repro_torch.models import layers

    full_f32()
    cfg = _reduced_f32("qwen2-moe-a2.7b", n_experts=8)
    p = layers.init_moe(torch.Generator().manual_seed(0), cfg)
    S = 1 if case.startswith("decode") else 16
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, S, cfg.d_model),
                                                                    dtype=np.float32))
    shape = {"dispatch_2x2": (2, 2), "dispatch_1x4": (1, 4), "decode_2x4": (2, 4)}[case]
    kw = dict(fsdp=True, serving=True) if case.startswith("decode") else {}
    out = {}
    for name, dev in (("host", torch.device("cpu")), ("card", cuda_device)):
        pol = _debug_policy(cfg, shape, dev, **kw)
        pd = tree_map(lambda t: t.to(dev), p)
        with torch.no_grad():
            y, aux = layers.apply_moe_ep(pd, x.to(dev), cfg, pol)
            kept = layers.moe_ep_kept(pd, x.to(dev), cfg, pol)
        out[name] = (y.cpu(), aux.cpu(), kept.cpu())
    scale = float(out["host"][0].abs().max())
    np.testing.assert_allclose(out["card"][0].numpy(), out["host"][0].numpy(), rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(float(out["card"][1]), float(out["host"][1]), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(out["card"][2], out["host"][2])
    if case == "dispatch_2x2":
        assert not bool(out["card"][2].all())  # capacity dropped a route


def test_sharded_mla_and_2d_ep_decode_on_the_card_match_the_host(cuda_device):
    """Reduced deepseek-v3 (MTP off) decoding under a (2, 2) serving FSDP
    policy on the card: MLA's sharded decode and the 2-D EP decode, every
    step's logits against the host's at rtol 1e-4 / atol 1e-5."""
    from repro_torch.models import kvcache

    full_f32()
    cfg = _reduced_f32("deepseek-v3-671b", mtp_depth=0)
    host = transformer.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 12)))
    logits = {}
    for name, dev in (("host", torch.device("cpu")), ("card", cuda_device)):
        params = tree_map(lambda t: t.to(dev), host)
        pol = _debug_policy(cfg, (2, 2), dev, fsdp=True, serving=True)
        cache = kvcache.init_cache(cfg, 4, 16, dtype=torch.float32, device=dev)
        logits[name] = torch.cat([transformer.decode_step(
            params, tokens[:, t:t + 1].to(dev), cache, t, cfg, policy=pol)[0].cpu()
            for t in range(12)], dim=1)
    V = cfg.vocab_size
    np.testing.assert_allclose(logits["card"][..., :V].numpy(), logits["host"][..., :V].numpy(),
                               rtol=1e-4, atol=1e-5)
