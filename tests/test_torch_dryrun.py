"""The pod tools' roofline and dry-run, held against the reference's.

* **The reference's side** runs once, in a subprocess with 512 XLA-forced
  host devices (its ``launch/dryrun.py`` sets that flag when imported, so it
  is never imported here): the compiled HLO text of a small ``psum`` and
  ``all_gather`` program on the 16x16 mesh, ``active_params`` of every
  arch, the record of its ``dryrun_aggregation`` for mamba2-780m on 2x16x16
  (compiled, nothing run), ``weighted_average`` on the port's seeded share
  and ``hierarchical_fedavg`` over a ``(2, 16, 16)`` mesh on the port's
  seeded ``(2, P_pad)`` stack of a small width (the reduced mamba2's).
* ``parse_collectives`` (on that HLO text and on hand-written lines),
  ``roofline_terms`` and ``model_flops`` are the reference's code: equal
  results, exactly.  ``HARDWARE`` has the reference's keys.
* ``step_costs`` counts a matmul's 2·M·N·K FLOPs and (MK + KN + MN)·4
  bytes, a reduced dense forward's matrix-product FLOPs as written out
  below, argument bytes exactly and a peak at least the arguments.
* ``dryrun_one`` counts every arch's train, prefill and decode step on
  ``meta`` (reduced configs at their full configs' SSD chunk) with
  ``status: "ok"`` and a ``useful_flops_ratio`` in (0, 1.05].
* ``dryrun_aggregation`` on the host equals the reference's values at the
  bars of ``tests/test_torch_kernels.py`` (atol = rtol = 1e-5) and its
  record's ``n_params``, share, ``model_bytes_per_chip`` and zero
  collectives equal the reference's; deepseek-v3-671b on 16x16 is refused
  before anything is allocated; the CLI refuses the pod lowering.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config, get_reduced
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import HARDWARE
from repro_torch.models import transformer
from repro_torch.tree import flatten

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_AGG_ARCH, _N = "mamba2-780m", 8
_HIER_SEED, _AGG_SEED = 5, 3
_SHAPES = ("train_4k", "prefill_32k", "decode_32k")  # one of each kind

# Hand-written collective lines: tuple outputs, iota and list replica groups,
# async -start/-done pairs, a metadata mention that is no invocation, and a
# group of one (no traffic).
_HLO_LINES = """
  %ar = (f32[2000]{0}, f32[]) all-reduce(f32[2000]{0} %a, f32[] %b), replica_groups=[16,16]<=[256], to_apply=%add
  %ag = bf16[64,128]{1,0} all-gather(bf16[4,128]{1,0} %c), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %ags = (bf16[4,128]{1,0}, bf16[64,128]{1,0}) all-gather-start(bf16[4,128]{1,0} %c), replica_groups=[32,8]<=[256]
  %agd = bf16[64,128]{1,0} all-gather-done((bf16[4,128]{1,0}, bf16[64,128]{1,0}) %ags)
  %rs = f32[8,16]{1,0} reduce-scatter(f32[128,16]{1,0} %d), replica_groups=[16,16]<=[256], dimensions={0}
  %a2a = s32[16,4]{1,0} all-to-all(s32[16,4]{1,0} %e), replica_groups={{0,1}}, dimensions={0}
  %cp = u8[1024]{0} collective-permute(u8[1024]{0} %f), source_target_pairs={{0,1},{1,0}}
  %one = f32[10]{0} all-reduce(f32[10]{0} %g), replica_groups={{0}}, to_apply=%add
  %m = f32[4]{0} add(f32[4]{0} %x, f32[4]{0} %y), metadata={op_name="all-reduce(x)"}
"""


def _hier_config():
    """The reduced mamba2: a small ``P_pad`` for the hierarchical stack."""
    return get_reduced(_AGG_ARCH)


def _pad(p: int, n: int) -> int:
    return -(-p // n) * n


def _reference_script() -> str:
    return textwrap.dedent(f'''
        import json, sys
        import numpy as np
        import jax, jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.compat import make_auto_mesh, shard_map
        from repro.configs import ARCHITECTURES, get_config
        from repro.core import aggregation
        from repro.launch import dryrun

        assert jax.device_count() == 512, jax.device_count()
        x = np.load(sys.argv[1])
        out = {{}}
        mesh = make_auto_mesh((16, 16), ("data", "model"))

        def body(a):
            return jax.lax.psum(a, "model"), jax.lax.all_gather(a, "data", tiled=True)

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=P("data", "model"),
                              out_specs=(P("data", None), P(None, "model")), check_vma=False))
        arg = jax.ShapeDtypeStruct((256, 512), jnp.float32,
                                   sharding=NamedSharding(mesh, P("data", "model")))
        out["hlo"] = f.lower(arg).compile().as_text()
        out["active_params"] = {{a: dryrun.active_params(get_config(a)) for a in ARCHITECTURES}}
        out["agg_record"] = dryrun.dryrun_aggregation({_AGG_ARCH!r}, {_N}, True)
        out["agg"] = np.asarray(aggregation.weighted_average(
            jnp.asarray(x["stack"]), jnp.asarray(x["weights"]))).tolist()
        pod = make_auto_mesh((2, 16, 16), ("pod", "data", "model"))
        stack = jax.device_put(jnp.asarray(x["hstack"]),
                               NamedSharding(pod, P("pod", ("data", "model"))))
        w = jax.device_put(jnp.asarray(x["hweights"]), NamedSharding(pod, P("pod")))
        with pod:
            out["hier"] = np.asarray(jax.jit(aggregation.hierarchical_fedavg(pod))(
                stack, w)).tolist()
        json.dump(out, open(sys.argv[2], "w"))
    ''')


def _share_inputs():
    """The port's seeded inputs of the two aggregates, as numpy."""
    share = _pad(get_config(_AGG_ARCH).param_count_estimate(), 512) // 512
    stack, w = dryrun.aggregation_inputs(_N, share, torch.device("cpu"), _AGG_SEED)
    width = _pad(_hier_config().param_count_estimate(), 512)
    hstack, hw = dryrun.aggregation_inputs(2, width, torch.device("cpu"), _HIER_SEED)
    return {"stack": stack.numpy(), "weights": w.numpy(), "hstack": hstack.numpy(),
            "hweights": hw.numpy()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_reference")
    np.savez(d / "in.npz", **_share_inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    run = subprocess.run([sys.executable, "-c", _reference_script(), str(d / "in.npz"),
                          str(d / "out.json")], capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return json.loads((d / "out.json").read_text())


# ---------------------------------------------------------------------------
# HARDWARE and the roofline helpers
# ---------------------------------------------------------------------------


def test_hardware_has_the_references_keys():
    from repro.launch.mesh import HARDWARE as JHARDWARE

    assert set(HARDWARE) == set(JHARDWARE)
    assert HARDWARE["peak_flops_bf16"] == 989.4e12 and HARDWARE["hbm_bandwidth"] == 3.35e12
    assert HARDWARE["hbm_bytes"] == 80 * 10**9 and HARDWARE["ici_link_bandwidth"] == 25e9


def _stats(s):
    return s.counts, s.bytes_per_chip, s.total_bytes


@pytest.mark.parametrize("n_devices", [1, 8, 256, 512])
def test_parse_collectives_on_hand_written_lines(n_devices):
    from repro.launch import roofline as jrl

    got = rl.parse_collectives(_HLO_LINES, n_devices)
    assert _stats(got) == _stats(jrl.parse_collectives(_HLO_LINES, n_devices))
    assert got.counts["all-gather"] >= 2 and got.counts["all-to-all"] == 1


def test_parse_collectives_on_the_references_compiled_hlo(reference):
    from repro.launch import roofline as jrl

    got = rl.parse_collectives(reference["hlo"], 256)
    assert _stats(got) == _stats(jrl.parse_collectives(reference["hlo"], 256))
    assert got.counts["all-reduce"] >= 1 and got.counts["all-gather"] >= 1, got.counts
    assert got.total_bytes > 0


@pytest.mark.parametrize("terms", [(1e15, 2e12, 3e9), (0.0, 1.0, 0.0), (7e9, 0.0, 5e11)])
def test_roofline_terms_and_model_flops_equal_the_references(terms):
    from repro.launch import roofline as jrl
    from repro.launch.mesh import HARDWARE as JHARDWARE

    assert rl.roofline_terms(*terms, hw=JHARDWARE) == jrl.roofline_terms(*terms, hw=JHARDWARE)
    assert rl.roofline_terms(*terms) == jrl.roofline_terms(*terms, hw=dict(HARDWARE))
    for kind in ("train", "prefill", "decode"):
        assert rl.model_flops(14_769_617_920, 1_048_576, kind) == jrl.model_flops(
            14_769_617_920, 1_048_576, kind)


def test_active_params_equal_the_references(reference):
    got = {a: dryrun.active_params(get_config(a)) for a in ARCHITECTURES}
    assert got == reference["active_params"]


# ---------------------------------------------------------------------------
# step_costs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_costs_of_one_matmul(dtype):
    M, K, N = 96, 40, 24
    a = torch.empty((M, K), dtype=dtype, device="meta")
    b = torch.empty((K, N), dtype=dtype, device="meta")
    c = rl.step_costs(torch.matmul, a, b)
    es = a.element_size()
    assert c.flops == 2 * M * N * K
    assert c.bytes_accessed == (M * K + K * N + M * N) * es
    assert c.argument_bytes == (M * K + K * N) * es
    assert c.peak_bytes == (M * K + K * N + M * N) * es and c.ops == 1


def test_step_costs_views_and_broadcasts():
    """A view moves nothing; a broadcast (stride-0) operand counts its own
    elements once; a reshape that must copy is a copy."""
    x = torch.empty((64, 32), device="meta")
    row = torch.empty((32,), device="meta")
    c = rl.step_costs(lambda x, r: x.t().sum() + (x * r.expand(64, 32)).sum(), x, row)
    assert c.flops == 0
    n = 64 * 32
    # sum of the transpose; mul (x, the expanded row, out); sum; add of two scalars
    want = (n + 1) * 4 + (n + 32 + n) * 4 + (n + 1) * 4 + 3 * 4
    assert c.bytes_accessed == want, (c.bytes_accessed, want)
    copy = rl.step_costs(lambda x: x.t().reshape(-1), x)
    assert copy.bytes_accessed == 2 * n * 4


def test_step_costs_peak_and_arguments():
    """Argument bytes are exact (a view and its base count once); the peak
    holds the arguments and the temporaries alive together."""
    a = torch.empty((1000,), device="meta")
    b = torch.empty((10, 10), dtype=torch.bfloat16, device="meta")

    def fn(a, a_view, b):
        t1 = a * 2  # 4000 B
        t2 = t1 + 1  # 4000 B, t1 still alive
        del t1
        t3 = t2 * 3  # 4000 B, t1 freed
        return t3.sum() + b.float().sum()

    c = rl.step_costs(fn, a, a[:10], b)
    args = 1000 * 4 + 100 * 2
    assert c.argument_bytes == args
    # at the last sum: t2, t3, t3's sum (4 B), b in f32 (400 B) and its sum
    assert c.peak_bytes == args + 2 * 4000 + 4 + 400 + 4, c.peak_bytes
    assert c.peak_bytes >= c.argument_bytes


def test_step_costs_of_a_reduced_dense_forward():
    """qwen3-14b's reduced config, f32, one forward on ``meta``: the counted
    FLOPs are the matrix products written out here."""
    cfg = dataclasses.replace(get_reduced("qwen3-14b"), dtype=torch.float32,
                              param_dtype=torch.float32)
    B, S = 2, 64
    params = transformer.abstract_params(cfg)
    tokens = torch.empty((B, S), dtype=torch.int64, device="meta")
    c = rl.step_costs(lambda p, t: transformer.forward(p, t, cfg), params, tokens)
    D, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    T, F, V = B * S, cfg.d_ff, cfg.padded_vocab_size
    per_layer = (2 * T * D * H * hd  # q
                 + 2 * 2 * T * D * KVH * hd  # k, v
                 + 2 * B * H * S * S * hd  # scores
                 + 2 * B * H * S * S * hd  # scores · v
                 + 2 * T * H * hd * D  # o
                 + 3 * 2 * T * D * F)  # gate, up, down
    head = 2 * T * D * V
    assert c.flops == cfg.n_layers * per_layer + head, (c.flops, cfg.n_layers * per_layer + head)
    args = sum(t.numel() * t.element_size() for t in [*flatten(params)[0], tokens])
    assert c.argument_bytes == args and c.peak_bytes >= c.argument_bytes


# ---------------------------------------------------------------------------
# dryrun_one
# ---------------------------------------------------------------------------


def _reduced(arch: str):
    return dataclasses.replace(get_reduced(arch), ssm_chunk=get_config(arch).ssm_chunk)


@pytest.mark.parametrize("arch", ARCHITECTURES)
@pytest.mark.parametrize("shape", _SHAPES)
def test_dryrun_one_counts_every_arch_and_kind(monkeypatch, arch, shape):
    monkeypatch.setattr(dryrun, "get_config", _reduced)
    rec = dryrun.dryrun_one(arch, shape)
    assert rec["status"] == "ok", rec
    assert rec["mesh"] == "1xH100" and rec["n_devices"] == 1
    assert rec["kind"] == INPUT_SHAPES[shape]["kind"]
    assert 0 < rec["useful_flops_ratio"] <= 1.05, rec["useful_flops_ratio"]
    assert rec["collective_bytes_per_chip"] == 0.0 and rec["collective_s"] == 0.0
    assert rec["peak_bytes_per_chip"] >= rec["argument_size_bytes"] > 0
    assert rec["fits"] == (rec["peak_bytes_per_chip"] <= HARDWARE["hbm_bytes"])
    assert rec["bound_s"] == max(rec["compute_s"], rec["memory_s"])
    json.dumps(rec)


def test_dryrun_one_skips_and_refuses_the_pod_lowering():
    rec = dryrun.dryrun_one("qwen3-14b", "long_500k")
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    with pytest.raises(ValueError, match="pod lowering"):
        dryrun.dryrun_one("qwen3-14b", "train_4k", multi_pod=True)
    with pytest.raises(ValueError, match="pod lowering"):
        dryrun.dryrun_one("qwen3-14b", "train_4k", hlo_dir="hlo")


# ---------------------------------------------------------------------------
# dryrun_aggregation
# ---------------------------------------------------------------------------


def test_dryrun_aggregation_matches_the_reference(reference):
    rec, out = dryrun._aggregate(_AGG_ARCH, _N, True, False, "cpu", _AGG_SEED)
    np.testing.assert_allclose(out.numpy(), np.asarray(reference["agg"], np.float32),
                               atol=1e-5, rtol=1e-5)
    ref = reference["agg_record"]
    assert rec["status"] == ref["status"] == "ok"
    for key in ("arch", "shape", "kind", "mesh", "n_devices", "n_params", "hierarchical",
                "model_bytes_per_chip"):
        assert rec[key] == ref[key], key
    assert rec["share"] == _pad(ref["n_params"], ref["n_devices"]) // ref["n_devices"]
    assert rec["stack_shape"] == [_N, rec["share"]]
    assert sum(ref["collective_counts_full_hlo"].values()) == 0
    assert rec["collective_counts_full_hlo"] == ref["collective_counts_full_hlo"]
    assert rec["collective_bytes_per_chip"] == 0.0
    assert rec["memory_s"] == rec["model_bytes_per_chip"] / HARDWARE["hbm_bandwidth"]
    assert len(rec["aggregate_ms_samples"]) == dryrun.AGG_REPEATS
    assert dryrun.dryrun_aggregation(_AGG_ARCH, _N, True, device="cpu",
                                     seed=_AGG_SEED)["share"] == rec["share"]


def test_hierarchical_mode_matches_the_references_psum(reference, monkeypatch):
    monkeypatch.setattr(dryrun, "_arch_config", lambda arch, kind="train": _hier_config())
    rec, out = dryrun._aggregate(_AGG_ARCH, 2, True, True, "cpu", _HIER_SEED)
    width = _pad(_hier_config().param_count_estimate(), 512)
    assert rec["stack_shape"] == [2, width] and rec["hierarchical"]
    assert rec["model_bytes_per_chip"] == 2 * width * 4 / 512
    np.testing.assert_allclose(out.numpy(), np.asarray(reference["hier"], np.float32),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="pod axis"):
        dryrun._aggregate(_AGG_ARCH, 2, False, True, "cpu", 0)


def test_a_share_past_the_cards_memory_is_refused_before_allocating(monkeypatch):
    def no_alloc(*a, **k):
        raise AssertionError("allocated before refusing")

    monkeypatch.setattr(dryrun, "aggregation_inputs", no_alloc)
    with pytest.raises(ValueError, match="94,362,946,560 bytes"):
        dryrun.dryrun_aggregation("deepseek-v3-671b", 8, False, device="cpu")


def test_the_cli_refuses_the_pod_lowering_and_writes_an_agg_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out-dir", str(tmp_path)]
    for extra in (["--save-hlo", "--arch", "qwen3-14b", "--shape", "train_4k"],
                  ["--multi-pod", "--arch", "qwen3-14b", "--shape", "train_4k"]):
        run = subprocess.run(cmd + extra, capture_output=True, text=True, env=env, timeout=120)
        assert run.returncode != 0 and "pod lowering" in run.stderr, run.stderr
    run = subprocess.run(cmd + ["--agg", "--multi-pod", "--arch", _AGG_ARCH, "--device", "cpu"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 0, run.stderr
    lines = (tmp_path / "agg_2x16x16_h100.jsonl").read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["status"] == "ok" and rec["arch"] == f"fedavg-{_AGG_ARCH}"
    assert rec["device"] == "cpu" and rec["mesh"] == "2x16x16"
    assert not (tmp_path / "1xH100.jsonl").exists()
