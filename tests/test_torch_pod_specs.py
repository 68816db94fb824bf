"""The pod tools' specs, held against the reference's ``launch/specs.py``.

* **The reference's side** runs once, in a subprocess with 512 XLA-forced
  host devices (the production meshes' size), on meshes from
  ``repro.compat.make_auto_mesh``: its ``transformer.abstract_params``
  (``jax.eval_shape`` of its init), ``param_specs``, ``cache_specs``,
  ``batch_specs``, ``opt_state_specs`` and ``input_specs``, each written as
  ``(path, spec, shape, dtype)`` rows to JSON.
* **The port's side** walks its own trees with
  ``repro_torch/tree.flatten_with_path`` (the reference's ``keystr`` form)
  under ``make_policy`` over ``make_production_mesh`` slot meshes of the
  host, and must give the same rows: names, shapes and dtypes exactly, and
  specs entry for entry (a one-name tuple read as the name, as
  ``PartitionSpec`` reads it).  Token ids and positions are int64 in the
  port where the reference's are int32.
* ``abstract_params`` draws nothing: it returns ``meta`` tensors, and
  deepseek-v3-671b's (671.7e9 parameters) in well under 10 s.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import SlotMesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.sharding import make_policy
from repro_torch.tree import flatten_with_path

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KINDS = {"train": "train_4k", "decode": "decode_32k"}
_BATCH_SHAPES = ("train_4k", "prefill_32k")
_OPT_ARCHS = ("qwen3-14b", "deepseek-v3-671b", "mamba2-780m")
_OPTIMIZERS = ("sgd", "momentum", "adamw", "adafactor")
# one combo of each kind: llava's prefix_embeds, whisper's memory
_INPUT_COMBOS = (("qwen3-14b", "train_4k", "adamw"), ("llava-next-34b", "prefill_32k", "adamw"),
                 ("whisper-large-v3", "decode_32k", "adamw"))
# the port's index dtype where the reference's is int32
_DTYPES = {"int32": "int64"}


def _reference_script() -> str:
    return textwrap.dedent(f'''
        import json, sys
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.compat import make_auto_mesh
        from repro.configs import ARCHITECTURES, get_config
        from repro.launch import specs
        from repro.launch.dryrun import _arch_config, _serving_fsdp
        from repro.models import transformer
        from repro.models.sharding import make_policy

        assert jax.device_count() == 512, jax.device_count()
        meshes = {{False: make_auto_mesh((16, 16), ("data", "model")),
                   True: make_auto_mesh((2, 16, 16), ("pod", "data", "model"))}}

        def spec(s):
            return [list(e) if isinstance(e, tuple) else e for e in s]

        def rows(tree):
            is_p = lambda x: isinstance(x, P)
            out = []
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_p)[0]:
                key = jax.tree_util.keystr(path)
                if isinstance(leaf, P):
                    out.append([key, spec(leaf)])
                else:
                    sh = getattr(leaf, "sharding", None)
                    sp = sh.spec if isinstance(sh, NamedSharding) else None
                    out.append([key, None if sp is None else spec(sp),
                                list(leaf.shape), str(leaf.dtype)])
            return out

        def policy(arch, kind, multi_pod):
            cfg = _arch_config(arch, kind)
            return cfg, make_policy(cfg, meshes[multi_pod], multi_pod=multi_pod,
                                    fsdp=_serving_fsdp(arch, kind), serving=kind == "decode")

        res = {{"abstract": {{}}, "params": {{}}, "cache": {{}}, "batch": {{}}, "opt": {{}},
                "inputs": {{}}}}
        for arch in ARCHITECTURES:
            ab = transformer.abstract_params(get_config(arch))
            res["abstract"][arch] = rows(ab)
            for kind in {tuple(_KINDS)!r}:
                for mp in (False, True):
                    cfg, pol = policy(arch, kind, mp)
                    res["params"][f"{{arch}}|{{kind}}|{{mp}}"] = rows(specs.param_specs(cfg, pol, ab))
            for mp in (False, True):
                cfg, pol = policy(arch, "decode", mp)
                caches, _ = specs.cache_specs(cfg, pol, 128, 32768)
                res["cache"][f"{{arch}}|{{mp}}"] = rows(caches)
                for shape in {_BATCH_SHAPES!r}:
                    cfg, pol = policy(arch, "train", mp)
                    res["batch"][f"{{arch}}|{{shape}}|{{mp}}"] = rows(
                        specs.batch_specs(cfg, pol, shape))
        for arch in {_OPT_ARCHS!r}:
            cfg, pol = policy(arch, "train", False)
            ab = transformer.abstract_params(cfg)
            p_specs = specs.param_specs(cfg, pol, ab)
            for opt in {_OPTIMIZERS!r}:
                res["opt"][f"{{arch}}|{{opt}}"] = rows(specs.opt_state_specs(opt, p_specs, ab))
        for arch, shape, opt in {_INPUT_COMBOS!r}:
            kind = {{"train_4k": "train", "prefill_32k": "prefill", "decode_32k": "decode"}}[shape]
            cfg, pol = policy(arch, kind, False)
            ins = specs.input_specs(cfg, pol, shape, optimizer_name=opt)
            res["inputs"][f"{{arch}}|{{shape}}"] = {{
                k: rows(v) for k, v in ins.items() if k != "optimizer"}}
            res["inputs"][f"{{arch}}|{{shape}}"]["keys"] = sorted(ins)
        json.dump(res, open(sys.argv[1], "w"))
    ''')


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("pod_specs_reference") / "ref.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    run = subprocess.run([sys.executable, "-c", _reference_script(), str(out)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return json.loads(out.read_text())


def _spec(s) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in s]


def _dtype(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _spec_paths(tree, path: str = "") -> list[str]:
    """The ``keystr`` path of every spec of a spec tree, in walk order."""
    if isinstance(tree, specs.Spec):
        return [path]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _spec_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for f, v in zip(tree._fields, tree) for p in _spec_paths(v, f"{path}.{f}")]
    return [p for i, v in enumerate(tree) for p in _spec_paths(v, f"{path}[{i}]")]


def _rows(tree) -> list:
    """``[path, spec]`` for a spec tree; ``[path, spec, shape, dtype]`` for a
    tree of ``meta`` tensors (``spec`` the tensor's attribute, or None)."""
    try:
        leaves, _ = specs._spec_leaves(tree)
    except TypeError:  # tensors
        return [[p, _spec(t.spec) if hasattr(t, "spec") else None, list(t.shape),
                 _dtype(t.dtype)] for p, t in flatten_with_path(tree)[0]]
    return [[p, _spec(s)] for p, s in zip(_spec_paths(tree), leaves)]


def _want(rows: list) -> list:
    """The reference's rows of token ids or positions, its int32 as the port's int64."""
    return [r[:3] + [_DTYPES.get(r[3], r[3])] if len(r) == 4 else r for r in rows]


def _policy(arch: str, kind: str, multi_pod: bool):
    cfg = dryrun._arch_config(arch, kind)
    return cfg, make_policy(cfg, make_production_mesh(multi_pod=multi_pod, device="cpu"),
                            multi_pod=multi_pod, fsdp=dryrun._serving_fsdp(arch, kind),
                            serving=kind == "decode")


# ---------------------------------------------------------------------------
# the mesh and abstract_params
# ---------------------------------------------------------------------------


def test_modules_export_the_references_names():
    """``specs`` the reference's ``__all__``; ``roofline`` the reference's
    and ``step_costs``; ``mesh`` the reference's four and ``SlotMesh``;
    ``transformer`` ``abstract_params``."""
    from repro.launch import mesh as jmesh
    from repro.launch import roofline as jroofline
    from repro.launch import specs as jspecs
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import roofline as troofline

    assert specs.__all__ == jspecs.__all__
    assert troofline.__all__ == jroofline.__all__ + ["StepCosts", "step_costs"]
    assert set(tmesh.__all__) == set(jmesh.__all__) | {"SlotMesh"}
    assert "abstract_params" in transformer.__all__
    for module in (specs, troofline, tmesh):
        assert all(hasattr(module, n) for n in module.__all__)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_shape_and_axes(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert isinstance(mesh, SlotMesh)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16})
    assert dict(mesh.shape) == want
    assert mesh.axis_names == tuple(want)
    assert {d for d in mesh.devices.reshape(-1)} == {torch.device("cpu")}


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_abstract_params_equal_the_references_eval_shape(reference, arch):
    ab = transformer.abstract_params(get_config(arch))
    leaves = flatten_with_path(ab)[0]
    assert all(t.device.type == "meta" for _, t in leaves)
    assert _rows(ab) == reference["abstract"][arch]


def test_abstract_params_draws_nothing_and_is_fast(monkeypatch):
    """deepseek-v3-671b's tree in under 10 s, with every draw refused."""
    def no_draw(*a, **k):
        raise AssertionError("abstract_params drew a random number")

    monkeypatch.setattr(torch, "rand", no_draw)
    monkeypatch.setattr(torch, "randn", no_draw)
    t0 = time.perf_counter()
    ab = transformer.abstract_params(get_config("deepseek-v3-671b"))
    seconds = time.perf_counter() - t0
    assert seconds < 10, seconds
    n = sum(t.numel() for _, t in flatten_with_path(ab)[0])
    assert n == 671_712_669_696, n


def test_init_params_unchanged_by_the_abstract_path():
    """``init_params`` still draws from its generator: two calls with one seed agree."""
    cfg = dataclasses.replace(get_config("qwen3-14b"), n_layers=1, d_model=32, n_heads=4,
                              n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64)
    a = transformer.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    b = transformer.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    for (pa, ta), (pb, tb) in zip(flatten_with_path(a)[0], flatten_with_path(b)[0]):
        assert pa == pb and ta.device.type == "cpu" and torch.equal(ta, tb)
    assert [r[2:] for r in _rows(a)] == [r[2:] for r in _rows(transformer.abstract_params(cfg))]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_param_specs_leaf_for_leaf(reference, arch):
    """Every arch, train and decode policies, on both production meshes."""
    ab = transformer.abstract_params(get_config(arch))
    for kind in _KINDS:
        for mp in (False, True):
            cfg, pol = _policy(arch, kind, mp)
            got = _rows(specs.param_specs(cfg, pol, ab))
            assert got == reference["params"][f"{arch}|{kind}|{mp}"], (kind, mp)


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_cache_and_batch_specs(reference, arch):
    """``cache_specs`` at decode_32k (specs, shapes, dtypes) and
    ``batch_specs`` at train_4k and prefill_32k, on both meshes."""
    for mp in (False, True):
        cfg, pol = _policy(arch, "decode", mp)
        caches, c_specs = specs.cache_specs(cfg, pol, 128, 32768)
        want = reference["cache"][f"{arch}|{mp}"]
        assert _rows(caches) == want
        assert [r[:2] for r in _rows(c_specs)] == [r[:2] for r in want]
        for shape in _BATCH_SHAPES:
            cfg, pol = _policy(arch, "train", mp)
            got = _rows(specs.batch_specs(cfg, pol, shape))
            assert got == _want(reference["batch"][f"{arch}|{shape}|{mp}"]), shape


def test_batch_specs_carry_the_frontends(reference):
    names = {a: [r[0] for r in reference["batch"][f"{a}|train_4k|False"]]
             for a in ("llava-next-34b", "whisper-large-v3")}
    assert "['prefix_embeds']" in names["llava-next-34b"]
    assert "['frames']" in names["whisper-large-v3"]


@pytest.mark.parametrize("arch", _OPT_ARCHS)
@pytest.mark.parametrize("opt", _OPTIMIZERS)
def test_opt_state_specs(reference, arch, opt):
    cfg, pol = _policy(arch, "train", False)
    ab = transformer.abstract_params(cfg)
    got = specs.opt_state_specs(opt, specs.param_specs(cfg, pol, ab), ab)
    want = reference["opt"][f"{arch}|{opt}"]
    assert _rows(got) == want


@pytest.mark.parametrize("combo", _INPUT_COMBOS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_input_specs_keys_shapes_dtypes(reference, combo):
    arch, shape, opt = combo
    kind = INPUT_SHAPES[shape]["kind"]
    cfg, pol = _policy(arch, kind, False)
    ins = specs.input_specs(cfg, pol, shape, optimizer_name=opt)
    want = reference["inputs"][f"{arch}|{shape}"]
    assert sorted(ins) == want["keys"]
    for key in ins:
        if key == "optimizer":
            assert ins[key].name == opt
            continue
        ids = key in ("batch", "tokens", "pos")
        assert _rows(ins[key]) == (_want(want[key]) if ids else want[key]), key
