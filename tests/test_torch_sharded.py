"""The column-sharded arena, held against the reference.

The port's sharded arena lies on a *slot mesh* (``launch/mesh``): each slot
names the device of its shard, and slots may share one, so four slots on the
host run the four-shard code path here.

* **The reductions.**  One module-scoped fixture runs the reference's eleven
  sharded reductions (``core/aggregation.py``'s eight and ``kernels/ops.py``'s
  three), ``fedavg_sharded``, ``secure_fedavg_arena(out_sharding=)`` and
  ``hierarchical_fedavg`` in one subprocess with 8 XLA-forced host devices,
  as ``tests/test_multidevice.py`` does, on a 4-wide
  ``make_controller_mesh(4)`` (a 2 x 2 ``("pod", "data")`` mesh for
  ``hierarchical_fedavg``), on numpy inputs from one seed with NaN in the
  dead rows, under a mask and the empty mask.  Each port function on 4 host
  slots is held against it: f32 means at atol = rtol = 1e-5, the int8 ones
  at 2e-5, the trimmed mean at 1e-5, the median bit for bit, the top-k
  scatter at rtol 1e-6, the secure sum bit for bit; and bit for bit against
  the port's own one-device rule.
* **The reference's fault.**  The reference's ``ArenaStore(mesh=)`` raises
  ``KeyError: 'd'`` under the installed jax (``src/repro/core/store.py``
  reads its axes back as a bare string), so the sharded store, controller and
  driver are held against the reference's *unsharded* controller, which the
  reference promises gives the same numbers.  A test records the fault.
* **The store**: its layout, writes landing in their columns, growth, the
  int8 refusal, the sparse arrays left whole, the checkpoint state equal to
  an unsharded arena's and its round trip bit-exact.
* **The controller and the driver**: sync, semi-sync, async, FedBuff, secure,
  ``trimmed_mean``, ``median``, the int8 arena on the int8 codec and top-k
  direct, each sharded over 4 slots, against the reference's unsharded
  controller at the bars of the existing twins (rtol 1e-4 / atol 1e-5; the
  int8 bar of ``tests/test_torch_int8.py``; top-k at the reference
  conformance test's rtol 1e-5 / atol 1e-6) and bit for bit against the
  port's own unsharded run; a sharded kill-and-resume; the refusals.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs import housing_mlp
from repro.core import transport as jtransport
from repro.launch import train as jtrain
from repro.models import mlp as jmlp
from repro.optim import sgd as jsgd
from repro_torch import optim as topt
from repro_torch.core import aggregation as tagg
from repro_torch.core import packing as tpack
from repro_torch.core import secure as tsec
from repro_torch.core import transport as ttransport
from repro_torch.core.store import ArenaStore
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sparse_agg as tsparse
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import SlotMesh, make_controller_mesh
from repro_torch.models import sharding as tsharding
from test_torch_int8 import assert_within_q8_bar
from test_torch_protocols import _fixed_step_time, _toy_learner

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = 4
N, P, K, GROUP = 6, 4096, 64, 256
DEAD = (2, 4)
SECURE_ROWS, SECURE_SEED = [0, 1, 3, 5], 11


def _mesh():
    return make_controller_mesh(SLOTS, "cpu")


# ---------------------------------------------------------------------------
# the reference's sharded functions, in one subprocess
# ---------------------------------------------------------------------------


def _inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(23)
    arena = rng.normal(size=(N, P)).astype(np.float32)
    arena[list(DEAD)] = np.nan
    q = rng.integers(-127, 128, size=(N, P), dtype=np.int8)
    scales = rng.uniform(0.001, 0.02, size=(N, P // GROUP)).astype(np.float32)
    scales[DEAD[0]] = np.nan
    scales[DEAD[1]] = 1e30
    indices = np.stack([rng.permutation(P)[:K] for _ in range(N)]).astype(np.int32)
    values = rng.normal(size=(N, K)).astype(np.float32)
    values[list(DEAD)] = np.nan
    return {
        "arena": arena, "stack": rng.normal(size=(N, P)).astype(np.float32),
        "weights": np.array([3, 1, 4, 1, 5, 9], np.float32),
        "mask": np.array([1, 1, 0, 1, 0, 1], np.float32),
        "empty": np.zeros((N,), np.float32),
        "num_examples": np.array([64, 32, 48, 16, 80, 8], np.float32),
        "versions": np.array([0, 2, 1, 4, 0, 3], np.float32),
        "q": q, "scales": scales, "indices": indices, "values": values,
        "secure_arena": (0.1 * rng.normal(size=(N, P))).astype(np.float32),
        "secure_weights": np.array([3, 1, 5, 9], np.float32),
        "pods": rng.normal(size=(2, P)).astype(np.float32),
        "pod_weights": np.array([1, 3], np.float32),
        "uneven": rng.normal(size=(N, P + 2)).astype(np.float32),
    }


CURRENT_VERSION = 5.0
TRIM_K = 1
# name -> (reference builder, its arguments after the mesh, the inputs it reads)
_REDUCTIONS = {
    "agg.masked_fedavg_sharded": ("A.masked_fedavg_sharded", "", "arena,weights,{m}"),
    "agg.masked_staleness_sharded": (
        "A.masked_staleness_sharded", "", f"arena,num_examples,versions,{CURRENT_VERSION},{{m}}"),
    "agg.masked_median_sharded": ("A.masked_median_sharded", "", "arena,weights,{m}"),
    "agg.masked_trimmed_mean_sharded": (
        "A.masked_trimmed_mean_sharded", f"trim_k={TRIM_K}", "arena,weights,{m}"),
    "agg.masked_fedavg_q8_sharded": (
        "A.masked_fedavg_q8_sharded", f"group={GROUP}", "q,scales,weights,{m}"),
    "agg.masked_staleness_q8_sharded": (
        "A.masked_staleness_q8_sharded", f"group={GROUP}",
        f"q,scales,num_examples,versions,{CURRENT_VERSION},{{m}}"),
    "agg.masked_fedavg_topk_sharded": (
        "A.masked_fedavg_topk_sharded", f"out_width={P}", "indices,values,weights,{m}"),
    "agg.masked_staleness_topk_sharded": (
        "A.masked_staleness_topk_sharded", f"out_width={P}",
        f"indices,values,num_examples,versions,{CURRENT_VERSION},{{m}}"),
    "ops.masked_fedavg_sharded": ("O.masked_fedavg_sharded", "", "arena,weights,{m}"),
    "ops.masked_fedavg_q8_sharded": (
        "O.masked_fedavg_q8_sharded", f"group={GROUP}", "q,scales,weights,{m}"),
    "ops.masked_trimmed_mean_sharded": (
        "O.masked_trimmed_mean_sharded", f"trim_k={TRIM_K}", "arena,weights,{m}"),
}
# atol = rtol per function; None: bit for bit
_BARS = {
    "agg.masked_fedavg_sharded": 1e-5, "agg.masked_staleness_sharded": 1e-5,
    "agg.masked_median_sharded": None, "agg.masked_trimmed_mean_sharded": 1e-5,
    "agg.masked_fedavg_q8_sharded": 2e-5, "agg.masked_staleness_q8_sharded": 2e-5,
    "agg.masked_fedavg_topk_sharded": 1e-6, "agg.masked_staleness_topk_sharded": 1e-6,
    "ops.masked_fedavg_sharded": 1e-5, "ops.masked_fedavg_q8_sharded": 2e-5,
    "ops.masked_trimmed_mean_sharded": 1e-5,
}


def _reference_script() -> str:
    calls = []
    for name, (builder, kw, args) in _REDUCTIONS.items():
        for m in ("mask", "empty"):
            argv = ", ".join(a if a[0].isdigit() else f"x[{a!r}]"
                             for a in args.format(m=m).split(","))
            sep = ", " if kw else ""
            calls.append(f"out[{name + '.' + m!r}] = {builder}(mesh{sep}{kw})({argv})")
    body = "\n".join(calls)
    return textwrap.dedent('''
        import sys
        import numpy as np
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
        from repro.core import aggregation as A
        from repro.core import secure as S
        from repro.kernels import ops as O
        from repro.launch.mesh import make_controller_mesh

        x = dict(np.load(sys.argv[1]))
        mesh = make_controller_mesh({slots})
        out = {{}}
    ''').format(slots=SLOTS) + body + textwrap.dedent(f'''

        out["fedavg_sharded"] = A.fedavg_sharded(mesh, x["stack"], x["weights"])
        row = NamedSharding(mesh, PS("data"))
        for p in ({P}, {P - 96}):
            out[f"secure.{{p}}"] = S.secure_fedavg_arena(
                jnp.asarray(x["secure_arena"]), {SECURE_ROWS}, list(x["secure_weights"]),
                num_params=p, base_seed={SECURE_SEED}, out_sharding=row)
        pods = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("pod", "data"))
        out["hierarchical"] = jax.jit(A.hierarchical_fedavg(pods))(x["pods"], x["pod_weights"])
        faults = {{}}
        try:
            A.masked_median_sharded(mesh)(x["uneven"], x["weights"], x["mask"])
        except Exception as e:
            faults["uneven"] = type(e).__name__
        from repro.core.store import ArenaStore
        try:
            ArenaStore(1000, mesh=mesh)
            faults["store"] = "built"
        except Exception as e:
            faults["store"] = type(e).__name__ + ": " + str(e)
        out = {{k: np.asarray(v) for k, v in out.items()}}
        for k, v in faults.items():
            out["fault." + k] = np.array(v)
        out["jax_version"] = np.array(jax.__version__)
        np.savez(sys.argv[2], **out)
    ''')


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded functions' outputs on :func:`_inputs`."""
    d = tmp_path_factory.mktemp("sharded_reference")
    np.savez(d / "in.npz", **_inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    run = subprocess.run([sys.executable, "-c", _reference_script(), str(d / "in.npz"),
                          str(d / "out.npz")], capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return dict(np.load(d / "out.npz"))


def _port_fn(name):
    builder, kw, _ = _REDUCTIONS[name]
    mod = tagg if builder.startswith("A.") else tops
    kwargs = {}
    if kw:
        key, val = kw.split("=")
        kwargs[key] = int(val)
    return getattr(mod, builder[2:])(_mesh(), **kwargs)


def _port_args(name, m):
    x = _inputs()
    return [float(a) if a[0].isdigit() else torch.from_numpy(x[a])
            for a in _REDUCTIONS[name][2].format(m=m).split(",")]


def _one_device(name, m):
    """The port's one-device rule on the same inputs."""
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    mask = x[m]
    if name.endswith("masked_fedavg_sharded"):
        return tagg.masked_fedavg(x["arena"], x["weights"], mask)
    if name == "agg.masked_staleness_sharded":
        return tagg.masked_staleness_average(x["arena"], x["num_examples"], x["versions"],
                                             CURRENT_VERSION, mask)
    if name == "agg.masked_median_sharded":
        return tagg.masked_coordinate_median(x["arena"], x["weights"], mask)
    if name.endswith("masked_trimmed_mean_sharded"):
        return tagg.masked_trimmed_mean(x["arena"], x["weights"], mask, TRIM_K)
    if name.endswith("masked_fedavg_q8_sharded"):
        return tagg.masked_fedavg_q8(x["q"], x["scales"], x["weights"], mask, GROUP)
    if name == "agg.masked_staleness_q8_sharded":
        return tagg.masked_staleness_q8(x["q"], x["scales"], x["num_examples"], x["versions"],
                                        CURRENT_VERSION, mask, group=GROUP)
    if name == "agg.masked_fedavg_topk_sharded":
        return tagg.masked_fedavg_topk(x["indices"], x["values"], x["weights"], mask, P)
    return tagg.masked_staleness_topk(x["indices"], x["values"], x["num_examples"],
                                      x["versions"], CURRENT_VERSION, mask, P)


@pytest.mark.parametrize("m", ["mask", "empty"])
@pytest.mark.parametrize("name", list(_REDUCTIONS))
def test_sharded_reduction_matches_the_reference(reference, name, m):
    got = _port_fn(name)(*_port_args(name, m))
    want = reference[f"{name}.{m}"]
    assert got.shape == want.shape == (P,)
    bar = _BARS[name]
    if bar is None:
        np.testing.assert_array_equal(got.numpy(), want)
    elif "topk" in name:
        np.testing.assert_allclose(got.numpy(), want, rtol=bar, atol=1e-7)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=bar, atol=bar)
    assert np.isfinite(got.numpy()).all()
    if m == "empty":
        assert not got.any()
    # the same bits as the port's one-device rule: every rule is per column
    assert torch.equal(got, _one_device(name, m))


def test_fedavg_sharded_matches_the_reference(reference):
    x = _inputs()
    got = tagg.fedavg_sharded(_mesh(), torch.from_numpy(x["stack"]),
                              torch.from_numpy(x["weights"]))
    np.testing.assert_allclose(got.numpy(), reference["fedavg_sharded"], rtol=1e-5, atol=1e-5)
    assert torch.equal(got, tagg.fedavg(torch.from_numpy(x["stack"]),
                                        torch.from_numpy(x["weights"])))


@pytest.mark.parametrize("p", [P, P - 96])
def test_secure_sharded_sum_is_the_references_bit_for_bit(reference, p):
    x = _inputs()
    arena = torch.from_numpy(x["secure_arena"])
    weights = [float(w) for w in x["secure_weights"]]
    _, row, _ = tsharding.arena_specs(_mesh())
    # a whole arena summed in the row layout, and the arena laid out as shards
    shards = tsharding.arena_specs(_mesh())[0].split(arena)
    for a in (arena, shards):
        got = tsec.secure_fedavg_arena(a, SECURE_ROWS, weights, num_params=p,
                                       base_seed=SECURE_SEED, out_sharding=row)
        np.testing.assert_array_equal(got.numpy(), reference[f"secure.{p}"])
    one_device = tsec.secure_fedavg_arena(arena, SECURE_ROWS, weights, num_params=p,
                                          base_seed=SECURE_SEED)
    assert torch.equal(got, one_device)


def test_hierarchical_fedavg_matches_the_reference(reference):
    x = _inputs()
    devices = np.empty((2, 2), dtype=object)
    devices[:] = torch.device("cpu")
    pods = SlotMesh(devices, ("pod", "data"))
    got = tagg.hierarchical_fedavg(pods)(torch.from_numpy(x["pods"]),
                                         torch.from_numpy(x["pod_weights"]))
    np.testing.assert_allclose(got.numpy(), reference["hierarchical"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), reference["hierarchical"])  # two pods: exact


def test_uneven_width_is_refused_like_the_reference(reference):
    assert str(reference["fault.uneven"]) == "ValueError"
    x = _inputs()
    with pytest.raises(ValueError, match="does not divide"):
        tagg.masked_median_sharded(_mesh())(torch.from_numpy(x["uneven"]),
                                            torch.from_numpy(x["weights"]),
                                            torch.from_numpy(x["mask"]))
    with pytest.raises(ValueError, match="not divisible by 4 shards"):
        tsparse.scatter_accumulate_sharded(_mesh(), ("data",), P + 2)


def test_reference_sharded_store_fails_under_this_jax(reference):
    """The switch of oracle: the reference's own ``ArenaStore(mesh=)`` cannot
    be built here, so the port's sharded store is held against its unsharded
    controller."""
    fault = str(reference["fault.store"])
    if fault == "built":
        pytest.skip(f"jax {reference['jax_version']} builds the reference's sharded store; "
                    "its sharded controller could be the oracle again")
    assert fault == "KeyError: 'd'", fault


# ---------------------------------------------------------------------------
# the slot mesh and the layouts
# ---------------------------------------------------------------------------


def test_controller_mesh_places_slots_round_robin():
    m = make_controller_mesh(SLOTS, "cpu")
    assert m.axis_names == ("data",) and dict(m.shape) == {"data": SLOTS}
    assert all(d == torch.device("cpu") for d in m.devices)
    assert make_controller_mesh(None, "cpu").devices.size == 1  # the host is one device
    assert make_controller_mesh(-1, "cpu").devices.size == 1
    with pytest.raises(ValueError, match="n_shards"):
        make_controller_mesh(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_controller_mesh(SLOTS)
        with pytest.raises(RuntimeError):
            SlotMesh(np.array([torch.device("cuda", 0)], dtype=object), ("data",))


def test_slot_devices_are_row_major_over_the_axes():
    grid = np.empty((2, 3), dtype=object)
    for i in range(2):
        for j in range(3):
            grid[i, j] = f"cpu:{i}{j}"  # labels stand in for devices below
    mesh = object.__new__(SlotMesh)
    object.__setattr__(mesh, "devices", grid)
    object.__setattr__(mesh, "axis_names", ("pod", "data"))
    assert mesh.slot_devices(("pod", "data")) == ("cpu:00", "cpu:01", "cpu:02",
                                                  "cpu:10", "cpu:11", "cpu:12")
    assert mesh.slot_devices(("data", "pod")) == ("cpu:00", "cpu:10", "cpu:01",
                                                  "cpu:11", "cpu:02", "cpu:12")
    assert mesh.slot_devices(("data",)) == ("cpu:00", "cpu:01", "cpu:02")
    with pytest.raises(ValueError, match="not one of"):
        mesh.slot_devices(("model",))
    with pytest.raises(ValueError, match="distinct axis names"):
        SlotMesh(np.array([torch.device("cpu")] * 2, dtype=object), ("data", "data"))


def test_arena_specs_axes_and_layouts():
    mesh = _mesh()
    buf, row, repl = tsharding.arena_specs(mesh)
    assert buf.axes == row.axes == repl.axes == ("data",) == tagg.arena_axes(mesh)
    assert tagg.arena_axes(mesh, "data") == ("data",)  # a bare name is one axis
    assert buf.n_shards == row.n_shards == SLOTS
    assert buf.windows(P) == [(s * 1024, (s + 1) * 1024) for s in range(SLOTS)]
    x = torch.arange(3 * P, dtype=torch.float32).reshape(3, P)
    shards = buf.split(x)
    assert isinstance(shards, tsharding.ColumnShards) and len(shards) == SLOTS
    assert shards.shape == (3, P) and shards.dtype == torch.float32
    assert shards.nbytes == x.nbytes and all(s.is_contiguous() for s in shards)
    assert torch.equal(shards.assemble("cpu"), x)
    assert buf.split(shards) is shards
    assert len(repl.put(torch.ones(N))) == SLOTS


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def test_sharded_store_layout_and_writes():
    p = 5000
    st = ArenaStore(p, n_max=2, mesh=_mesh(), device="cpu")
    assert st.sharded and st.n_shards == SLOTS and st.axes == ("data",)
    assert st.padded_params == 8192 and st.shard_width == 2048  # round_up(P, 1024 * 4)
    assert [tuple(s.shape) for s in st.buffer] == [(2, 2048)] * SLOTS
    assert st.buffer_sharding.windows(st.padded_params) == [(0, 2048), (2048, 4096),
                                                            (4096, 6144), (6144, 8192)]
    rows = [torch.arange(p, dtype=torch.float32) + 10_000 * i for i in range(3)]
    for i, r in enumerate(rows):
        st.write(f"l{i}", r, weight=i + 1.0, version=float(i))
    assert st.grow_events == 1 and st.n_max == 4  # the third learner grew it
    for i, r in enumerate(rows):
        assert torch.equal(st.row_view(f"l{i}"), r)
        for s, (a, b) in enumerate(st.buffer_sharding.windows(st.padded_params)):
            want = torch.nn.functional.pad(r, (0, st.padded_params - p))[a:b]
            assert torch.equal(st.buffer[s][i], want)
    one = ArenaStore(p, n_max=2, row_align=4096, device="cpu")  # the same row width
    for i, r in enumerate(rows):
        one.write(f"l{i}", r, weight=i + 1.0, version=float(i))
    assert st.resident_bytes() == one.resident_bytes()
    assert st.bytes_ingested == 3 * 4 * st.padded_params  # rows are padded before they land


def test_sharded_int8_store_refuses_a_shard_of_partial_groups():
    with pytest.raises(ValueError, match="per-shard row width 256 divisible by the quant "
                                         "group 512"):
        ArenaStore(1000, row_align=128, mesh=_mesh(), arena_dtype="int8", qgroup=512,
                   device="cpu")
    st = ArenaStore(1000, row_align=256, mesh=_mesh(), arena_dtype="int8", device="cpu")
    assert st.shard_width == 256 and [tuple(s.shape) for s in st.scales] == [(8, 1)] * SLOTS
    row = torch.linspace(-1, 1, 1000)
    st.write("a", row, weight=1.0)
    q, s = tops.quantize(torch.nn.functional.pad(row, (0, 24)), block_rows=1)
    assert torch.equal(torch.cat([b[0] for b in st.buffer]), q)
    assert torch.equal(st.row_view("a"),
                       (q.float().reshape(-1, 256) * s[:, None]).reshape(-1)[:1000])


def test_sharded_store_keeps_the_sparse_arrays_whole():
    st = ArenaStore(5000, mesh=_mesh(), arena_dtype="topk", sparse_k=48, device="cpu")
    assert isinstance(st.buffer, torch.Tensor) and isinstance(st.indices, torch.Tensor)
    assert tuple(st.buffer.shape) == tuple(st.indices.shape) == (8, 48)
    assert st.padded_params == 8192 and st.scales is None


@pytest.mark.parametrize("arena_dtype", ["f32", "int8"])
def test_sharded_export_state_is_the_unsharded_layout(arena_dtype):
    p = 5000
    sharded = ArenaStore(p, n_max=2, mesh=_mesh(), arena_dtype=arena_dtype, device="cpu")
    one = ArenaStore(p, n_max=2, row_align=4096, arena_dtype=arena_dtype, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for i in range(3):
        r = torch.randn(p, generator=gen)
        for st in (sharded, one):
            st.write(f"l{i}", r, weight=i + 1.0, version=float(i))
    sharded.invalidate("l1")
    one.invalidate("l1")
    got, want = sharded.export_state(), one.export_state()
    assert got.keys() == want.keys() and got["rows"] == want["rows"]
    for key in got:
        if key != "rows":
            np.testing.assert_array_equal(got[key], want[key])
    back = ArenaStore(p, n_max=2, mesh=_mesh(), arena_dtype=arena_dtype, device="cpu")
    back.restore_state(**got)
    again = back.export_state()
    for key in got:
        if key != "rows":
            assert again[key].tobytes() == got[key].tobytes()
    assert all(isinstance(b, torch.Tensor) for b in back.buffer) and len(back.buffer) == SLOTS
    for lid in ("l0", "l2"):
        assert torch.equal(back.row_view(lid), one.row_view(lid))


# ---------------------------------------------------------------------------
# the controller and the driver
# ---------------------------------------------------------------------------

_FEDERATIONS = {
    "sync": dict(proto=lambda m: m.SyncProtocol(local_steps=2, batch_size=32,
                                                learning_rate=0.01), n=3, rounds=2),
    "semi_sync": dict(proto=lambda m: m.SemiSyncProtocol(
        hyperperiod_s=0.0055, batch_size=32, learning_rate=0.01, default_steps=2),
        n=3, rounds=2),
    "async": dict(proto=lambda m: m.AsyncProtocol(local_steps=2, batch_size=32,
                                                  learning_rate=0.01), n=3, updates=4),
    "buffered_async": dict(proto=lambda m: m.BufferedAsyncProtocol(
        buffer_k=3, local_steps=2, batch_size=32, learning_rate=0.01), n=4, updates=2),
    "secure": dict(proto=lambda m: m.SyncProtocol(local_steps=2, batch_size=32,
                                                  learning_rate=0.01), n=3, rounds=2,
                   secure=True),
    "secure_async": dict(proto=lambda m: m.AsyncProtocol(local_steps=2, batch_size=32,
                                                         learning_rate=0.01), n=3, updates=4,
                         secure=True),
    "trimmed_mean": dict(proto=lambda m: m.SyncProtocol(local_steps=2, batch_size=32,
                                                        learning_rate=0.01), n=5, rounds=2,
                         aggregation_rule="trimmed_mean", trim_k=1),
    "median": dict(proto=lambda m: m.SyncProtocol(local_steps=2, batch_size=32,
                                                  learning_rate=0.01), n=4, rounds=2,
                   aggregation_rule="median"),
    "int8_arena": dict(proto=lambda m: m.SyncProtocol(local_steps=2, batch_size=32,
                                                      learning_rate=0.01), n=3, rounds=2,
                       upload_codec="int8", arena_dtype="int8"),
    "int8_async": dict(proto=lambda m: m.AsyncProtocol(local_steps=2, batch_size=32,
                                                       learning_rate=0.01), n=3, updates=4,
                       upload_codec="int8", arena_dtype="int8"),
}
# Every counter of the protocol twins but the byte counts: a 4-slot arena pads
# its rows to 4 x 1024 columns, so its uploads are longer.
_COUNTERS = ("channel.messages", "channel.upload_messages",
             "controller.dispatch_serializations", "controller.model_version",
             "engine.round_id", "engine.uploads.quantized_direct",
             "controller.aggregations.fused_q8", "controller.aggregations.sparse_scatter",
             "engine.uploads.sparse_direct", "store.arena.total_writes")


def _federation(side, case, mesh=None):
    m = J if side == "reference" else T
    dev = {} if side == "reference" else {"device": "cpu"}
    kw = {k: v for k, v in case.items() if k not in ("proto", "n", "rounds", "updates")}
    init = jmlp.init_params(jax.random.key(0), housing_mlp.reduced())
    if side == "reference":
        _, learners = jtrain.build_housing_learners("100k", case["n"], 0, optimizer=jsgd(0.01))
    else:
        _, learners = ttrain.build_housing_learners("100k", case["n"], 0,
                                                    optimizer=topt.sgd(0.01), device="cpu")
        init = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, init), "cpu")
        kw["arena_mesh"] = mesh
    if case.get("arena_dtype") != "int8":
        kw["arena_row_align"] = 64  # 1057 params over 4 slots of 320 columns: all hold some
    ctrl = m.Controller(protocol=case["proto"](m), arena_n_max=case["n"],
                        max_dispatch_workers=1, **kw, **dev)
    ctrl.set_initial_model(init)
    for i, learner in enumerate(learners):
        ctrl.register_learner(_fixed_step_time(learner, 1e-3 * (i + 1)))
    if case.get("updates"):
        ctrl.engine.run(total_updates=case["updates"])
    else:
        ctrl.engine.run(rounds=case["rounds"])
    ctrl.shutdown()
    counters = {k: ctrl.telemetry.value(k, 0) for k in _COUNTERS}
    return np.array(ctrl.global_buffer), counters, ctrl


@pytest.mark.parametrize("name", list(_FEDERATIONS))
def test_sharded_controller_matches_the_reference(name):
    case = _FEDERATIONS[name]
    got, tcount, ctrl = _federation("port", case, mesh=_mesh())
    want, jcount, _ = _federation("reference", case)
    assert ctrl.arena.sharded and len(ctrl.arena.buffer) == SLOTS
    assert tcount == jcount
    assert np.isfinite(got).all()
    if case.get("upload_codec") == "int8":
        assert_within_q8_bar(got, want, what=name)
        assert tcount["engine.uploads.quantized_direct"] == tcount["channel.upload_messages"]
        assert tcount["controller.aggregations.fused_q8"] == tcount["controller.model_version"]
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    one, ocount, _ = _federation("port", case)
    assert ocount == tcount
    np.testing.assert_array_equal(got, one)  # the unsharded port run, bit for bit


def _topk(side, mesh=None, **kw):
    m = J if side == "reference" else T
    tr = jtransport if side == "reference" else ttransport
    extra = {} if side == "reference" else {"device": "cpu", "arena_mesh": mesh}
    ctrl = m.Controller(protocol=m.SyncProtocol(local_steps=2, batch_size=16),
                        upload_codec=tr.TopkUploadCodec(k=2), sparse_mode="direct",
                        max_dispatch_workers=1, **kw, **extra)
    zeros = np.zeros((4, 1), np.float32)
    ctrl.set_initial_model({"w": zeros if side == "reference" else torch.from_numpy(zeros)})
    for i in range(3):
        ctrl.register_learner(_toy_learner(side, i))
    ctrl.engine.run(rounds=2)
    ctrl.shutdown()
    return np.array(ctrl.global_buffer), ctrl


def test_sharded_topk_direct_matches_the_reference():
    """The reference conformance tests' toy learner (4 params), on a row of one
    column a slot, so every slot scatters its own coordinate."""
    got, ctrl = _topk("port", mesh=_mesh(), arena_row_align=1)
    want, _ = _topk("reference", arena_row_align=1)
    assert ctrl.arena.padded_params == 4 and ctrl._sharded_topk_fn is not None
    assert ctrl.telemetry.value("controller.aggregations.sparse_scatter") == 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got, _topk("port", arena_row_align=1)[0])


def test_sharded_topk_direct_on_the_housing_model_is_the_unsharded_run():
    case = dict(_FEDERATIONS["sync"], upload_codec=ttransport.TopkUploadCodec(k=64),
                sparse_mode="direct")
    got, count, ctrl = _federation("port", case, mesh=_mesh())
    one, ocount, _ = _federation("port", case)
    assert count == ocount and count["engine.uploads.sparse_direct"] == 6
    assert ctrl.arena.shard_width * SLOTS == ctrl.arena.padded_params >= got.shape[0]
    np.testing.assert_array_equal(got, one)


def test_driver_arena_shards_matches_the_reference():
    n, rounds = 4, 2
    jinit = jmlp.init_params(jax.random.key(0), housing_mlp.reduced())
    tinit = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jinit), "cpu")
    _, jl = jtrain.build_housing_learners("100k", n, 0)
    _, tl = ttrain.build_housing_learners("100k", n, 0, device="cpu")
    kw = dict(local_steps=2, batch_size=32, learning_rate=0.01)
    jd = J.Driver(J.FederationEnv(termination=J.TerminationCriteria(max_rounds=rounds), **kw))
    td = T.Driver(T.FederationEnv(termination=T.TerminationCriteria(max_rounds=rounds),
                                  arena_shards=SLOTS, device="cpu", **kw))
    mesh = td.controller.arena_mesh
    assert mesh is not None and dict(mesh.shape) == {"data": SLOTS}
    jd.initialize(jinit, jl)
    td.initialize(tinit, tl)
    assert len(td.run()) == len(jd.run()) == rounds
    arena = td.controller.arena
    assert arena.sharded and arena.n_shards == SLOTS
    np.testing.assert_allclose(np.asarray(td.controller.global_buffer),
                               np.asarray(jd.controller.global_buffer), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_sharded_kill_and_resume_bit_identical(codec, tmp_path):
    kw = dict(upload_codec=codec, arena_dtype="f32" if codec == "raw" else "int8")

    def build(**extra):
        cfg, fleet = ttrain.build_housing_learners("100k", 3, 0, optimizer=topt.sgd(0.01),
                                                   device="cpu")
        for learner in fleet:  # a constant batch, as the reference's harness trains
            batch = learner._eval_data_fn()
            learner._data_fn = lambda bs, b=batch: b
        ctrl = T.Controller(protocol=T.SyncProtocol(local_steps=2, batch_size=32),
                            arena_n_max=3, max_dispatch_workers=1, arena_mesh=_mesh(),
                            device="cpu", **kw, **extra)
        init = tpack.tree_from_numpy(jax.tree_util.tree_map(
            np.asarray, jmlp.init_params(jax.random.key(0), housing_mlp.reduced())), "cpu")
        ctrl.set_initial_model(init)
        for learner in fleet:
            ctrl.register_learner(learner)
        return ctrl

    golden = build()
    golden.engine.run(rounds=4)
    golden.shutdown()
    ckpt = str(tmp_path / "ckpt")
    first = build(checkpoint_every=2, checkpoint_dir=ckpt)
    first.engine.run(rounds=2)
    first.shutdown()
    resumed = build()
    assert resumed.restore(ckpt)["round_id"] == 2
    assert resumed.arena.sharded and len(resumed.arena.buffer) == SLOTS
    resumed.engine.run(rounds=2)
    resumed.shutdown()
    np.testing.assert_array_equal(np.array(resumed.global_buffer),
                                  np.array(golden.global_buffer))


def test_a_custom_masked_rule_gets_the_assembled_arena():
    seen = []

    def rule(arena, weights, mask):
        seen.append((type(arena), tuple(arena.shape)))
        return tagg.masked_weighted_average(arena, weights, mask)

    case = dict(_FEDERATIONS["sync"], masked_aggregate_fn=rule)
    got, _, ctrl = _federation("port", case, mesh=_mesh())
    assert ctrl._sharded_masked_fn is None
    assert seen == [(torch.Tensor, (3, 1280))] * 2 and ctrl.arena.padded_params == 1280
    np.testing.assert_array_equal(got, _federation("port", _FEDERATIONS["sync"], mesh=_mesh())[0])


def test_sharding_with_a_stack_store_is_refused_like_the_reference():
    for m, dev in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError, match="arena_mesh= requires store_mode='arena'"):
            m.Controller(store_mode="stack", arena_mesh=object(), **dev)
        with pytest.raises(ValueError, match="arena_shards requires an arena store"):
            m.Driver(m.FederationEnv(store_mode="stack", arena_shards=SLOTS, **dev))
    # the auto pick of the stack store (a lineage of two) drops the knob, as the reference's does
    d = T.Driver(T.FederationEnv(lineage_length=2, arena_shards=SLOTS, device="cpu"))
    assert d.controller.store_mode == "stack" and d.controller.arena_mesh is None
