"""The model axis, held against the reference's own sharded functions.

The reference runs a model over a mesh with ``ShardingPolicy`` and three
``shard_map`` bodies: the expert-parallel MoE (``apply_moe_ep``, its
dispatch body and its weights-stationary 2-D decode body), flash decoding
over a sequence-sharded KV cache (``_flash_decode``) and MLA's absorbed
decode over a sharded latent cache.  The port runs each body once a slot of
a slot mesh (``launch/mesh.make_debug_mesh``, every slot on the host here).

* **The reference's side** runs in one subprocess with 8 XLA-forced host
  devices, as ``tests/test_torch_sharded.py`` does, on meshes from
  ``repro.compat.make_auto_mesh`` (every axis Auto: ``jax.make_mesh`` gives
  Explicit axes under jax 0.9.0, which the reference's
  ``with_sharding_constraint`` refuses, so its own multi-device tests of
  these paths fail).  Inputs come from numpy with a seed; the subprocess
  writes the reference's weights and results to an ``.npz`` and
  ``core/packing.tree_from_numpy`` carries the weights into the port.
  Every case runs in f32.
* **The bars.**  ``make_policy``'s fields exactly; ``apply_moe_ep``'s output
  within 1e-5 of the largest |output| and its aux loss within 1e-6, with the
  same kept assignments (the reference's output rebuilt from the port's
  kept routes; capacity drops some); each decode step's logits within 1e-5
  and the cache written in place; the pod-policy train step's loss within
  1e-5 relative and its updated parameters within 1e-5; the sharded serve
  and prefill steps' tokens equal.
* **The one-device path.**  ``constrain`` and ``seq_constrain`` return the
  very tensor; without a policy, or with an inactive one, the model's
  functions give today's bits.
* **The prefill repair.**  The port's ``make_prefill_step`` passes whisper's
  ``frames`` to the forward, as the reference does: its next tokens equal
  the reference's on reduced whisper-large-v3.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch import optim as topt
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.core import packing as tpack
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import SlotMesh, make_debug_mesh
from repro_torch.models import kvcache as tkv
from repro_torch.models import layers as tlayers
from repro_torch.models import sharding as tsharding
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.tree import flatten, flatten_with_path, unflatten

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the MoE of tests/test_multidevice.py, and the reduced MoE families
_MOE_T = dict(name="t", arch_type="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
              d_ff=64, vocab_size=100, n_experts=4, top_k=2, moe_d_ff=48, n_shared_experts=1,
              shared_d_ff=48, capacity_factor=4.0)
_MOE_CFGS = ("t", "qwen2-moe-a2.7b", "deepseek-v3-671b")
_MOE_CASES = [(c, mesh, fsdp) for c in _MOE_CFGS for mesh in ((2, 2), (1, 2))
              for fsdp in (False, True)]
_MOE_SHAPE = (4, 16)  # (B, S)
# name -> (arch, mesh, make_policy kwargs, batch, positions, cache length)
_DECODES = {
    "gemma3_1x4": ("gemma3-4b", (1, 4), {}, 4, 40, 40),
    "gemma3_2x4": ("gemma3-4b", (2, 4), {}, 4, 40, 40),
    "qwen3_1x4": ("qwen3-14b", (1, 4), {}, 4, 12, 16),
    "deepseek_2x2": ("deepseek-v3-671b", (2, 2), dict(fsdp=True, serving=True), 4, 12, 16),
    "qwen2moe_2x2": ("qwen2-moe-a2.7b", (2, 2), dict(fsdp=True, serving=True), 4, 12, 16),
}
_TRAIN_ARCHS = ("qwen3-14b", "qwen2-moe-a2.7b")
_TRAIN_SHAPE = (4, 16)
_TRAIN_LR = 0.1
_SERVE = ("gemma3-4b", (2, 4), 4, 10, 32)  # arch, mesh, batch, steps, cache length
_PREFILL = ("qwen2-moe-a2.7b", (2, 2), (4, 16))  # arch, mesh, (B, S)


def _cfg_kwargs(name: str) -> dict:
    return dict(mtp_depth=0) if name == "deepseek-v3-671b" else {}


def _tcfg(name: str) -> TModelConfig:
    if name == "t":
        return TModelConfig(**_MOE_T)
    return dataclasses.replace(tget_reduced(name), dtype=torch.float32, **_cfg_kwargs(name))


def _inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(31)
    out = {}
    for c in _MOE_CFGS:
        d = _tcfg(c).d_model
        out[f"moe.{c}.x"] = rng.standard_normal((*_MOE_SHAPE, d), dtype=np.float32)
    for name, (arch, _, _, B, S, _) in _DECODES.items():
        out[f"decode.{name}.tokens"] = rng.integers(0, _tcfg(arch).vocab_size, (B, S))
    for arch in _TRAIN_ARCHS:
        out[f"train.{arch}.tokens"] = rng.integers(0, _tcfg(arch).vocab_size, _TRAIN_SHAPE)
    out["prefill.tokens"] = rng.integers(0, _tcfg(_PREFILL[0]).vocab_size, _PREFILL[2])
    return out


def _reference_script() -> str:
    return textwrap.dedent(f'''
        import dataclasses, sys
        import numpy as np
        import jax, jax.numpy as jnp
        from repro.compat import make_auto_mesh
        from repro.configs import get_reduced
        from repro.launch.steps import make_prefill_step, make_serve_step, make_train_step
        from repro.models import kvcache, layers, transformer
        from repro.models.config import ModelConfig
        from repro.models.sharding import make_policy
        from repro.optim import sgd

        x = dict(np.load(sys.argv[1]))
        out = {{}}

        def cfg_of(name):
            if name == "t":
                return ModelConfig(**{_MOE_T!r})
            kw = {{"mtp_depth": 0}} if name == "deepseek-v3-671b" else {{}}
            return dataclasses.replace(get_reduced(name), dtype=jnp.float32, **kw)

        def save_tree(prefix, tree):
            for i, (path, leaf) in enumerate(jax.tree_util.tree_flatten_with_path(tree)[0]):
                out[f"{{prefix}}.w{{i}}"] = np.asarray(leaf)
                out[f"{{prefix}}.n{{i}}"] = np.array(jax.tree_util.keystr(path))

        def mesh2(shape):
            return make_auto_mesh(shape, ("data", "model"))

        # apply_moe_ep, both meshes, FSDP or not
        for c in {list(_MOE_CFGS)!r}:
            cfg = cfg_of(c)
            p = layers.init_moe(jax.random.key(3), cfg)
            save_tree(f"moe.{{c}}", p)
            xx = jnp.asarray(x[f"moe.{{c}}.x"])
            for shape in ((2, 2), (1, 2)):
                for fsdp in (False, True):
                    pol = make_policy(cfg, mesh2(shape), fsdp=fsdp)
                    y, aux = jax.jit(lambda pp, xv: layers.apply_moe_ep(pp, xv, cfg, pol))(p, xx)
                    key = f"moe.{{c}}.{{shape[0]}}x{{shape[1]}}.{{fsdp}}"
                    out[key + ".y"], out[key + ".aux"] = np.asarray(y), np.asarray(aux)
                    if shape == (2, 2):  # the aux loss's gradient with respect to the router
                        out[key + ".aux_grad"] = np.asarray(jax.jit(jax.grad(
                            lambda r, xv: layers.apply_moe_ep({{**p, "router": r}}, xv, cfg,
                                                              pol)[1]))(p["router"], xx))

        # decodes under a policy: flash decode, MLA's sharded decode, the 2-D EP decode
        for name, (arch, shape, kw, B, S, L) in {_DECODES!r}.items():
            cfg = cfg_of(arch)
            pol = make_policy(cfg, mesh2(shape), **kw)
            params = transformer.init_params(jax.random.key(5), cfg)
            save_tree(f"decode.{{name}}", params)
            toks = jnp.asarray(x[f"decode.{{name}}.tokens"], jnp.int32)
            cache = kvcache.init_cache(cfg, B, L, dtype=jnp.float32)
            step = jax.jit(lambda p, c, t, i: transformer.decode_step(p, t, c, i, cfg,
                                                                      policy=pol))
            logits = []
            for t in range(S):
                lg, cache = step(params, cache, toks[:, t:t + 1], jnp.asarray(t, jnp.int32))
                logits.append(np.asarray(lg))
            out[f"decode.{{name}}.logits"] = np.concatenate(logits, axis=1)
            for i, leaf in enumerate(jax.tree_util.tree_leaves(cache)):
                out[f"decode.{{name}}.cache{{i}}"] = np.asarray(leaf)

        # the train step under a (2, 2, 2) pod policy with FSDP
        pod = make_auto_mesh((2, 2, 2), ("pod", "data", "model"))
        for arch in {list(_TRAIN_ARCHS)!r}:
            cfg = cfg_of(arch)
            pol = make_policy(cfg, pod, multi_pod=True, fsdp=True)
            params = transformer.init_params(jax.random.key(7), cfg)
            save_tree(f"train.{{arch}}", params)
            toks = jnp.asarray(x[f"train.{{arch}}.tokens"], jnp.int32)
            opt = sgd({_TRAIN_LR})
            new, _, loss = jax.jit(make_train_step(cfg, opt, pol))(
                params, opt.init(params), {{"tokens": toks, "labels": toks}})
            out[f"train.{{arch}}.loss"] = np.asarray(loss)
            for i, leaf in enumerate(jax.tree_util.tree_leaves(new)):
                out[f"train.{{arch}}.new{{i}}"] = np.asarray(leaf)

        # the serve step over a sharded cache, greedy from token 0
        arch, shape, B, steps, L = {_SERVE!r}
        cfg = cfg_of(arch)
        pol = make_policy(cfg, mesh2(shape))
        params = transformer.init_params(jax.random.key(9), cfg)
        save_tree("serve", params)
        cache = kvcache.init_cache(cfg, B, L, dtype=jnp.float32)
        step = jax.jit(make_serve_step(cfg, pol))
        tok = jnp.zeros((B, 1), jnp.int32)
        toks = []
        for t in range(steps):
            tok, cache = step(params, cache, tok, jnp.asarray(t, jnp.int32), None)
            toks.append(np.asarray(tok))
        out["serve.tokens"] = np.concatenate(toks, axis=1)

        # the prefill step under a policy (the EP dispatch body)
        arch, shape, _ = {_PREFILL!r}
        cfg = cfg_of(arch)
        params = transformer.init_params(jax.random.key(11), cfg)
        save_tree("prefill", params)
        pol = make_policy(cfg, mesh2(shape))
        toks = jnp.asarray(x["prefill.tokens"], jnp.int32)
        out["prefill.next"] = np.asarray(jax.jit(make_prefill_step(cfg, pol))(
            params, {{"tokens": toks}}))
        out["prefill.next_unsharded"] = np.asarray(jax.jit(make_prefill_step(cfg))(
            params, {{"tokens": toks}}))
        np.savez(sys.argv[2], **out)
    ''')


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded functions' weights and results on :func:`_inputs`."""
    d = tmp_path_factory.mktemp("model_axis_reference")
    np.savez(d / "in.npz", **_inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    run = subprocess.run([sys.executable, "-c", _reference_script(), str(d / "in.npz"),
                          str(d / "out.npz")], capture_output=True, text=True, env=env,
                         timeout=900)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return dict(np.load(d / "out.npz"))


def _carry(ref: dict, prefix: str, skeleton):
    """The reference's weights under ``prefix`` as the port's tree, leaf by
    leaf into ``skeleton``'s structure, names checked."""
    named, structure = flatten_with_path(skeleton)
    names = [str(ref[f"{prefix}.n{i}"]) for i in range(len(named))]
    assert names == [n for n, _ in named]
    leaves = [tpack.tree_from_numpy(ref[f"{prefix}.w{i}"]) for i in range(len(named))]
    assert [tuple(t.shape) for t in leaves] == [tuple(t.shape) for _, t in named]
    return unflatten(structure, leaves)


def _params(ref: dict, prefix: str, cfg):
    return _carry(ref, prefix, ttf.init_params(torch.Generator().manual_seed(0), cfg, "cpu"))


def _policy(cfg, shape, **kw):
    return tsharding.make_policy(cfg, make_debug_mesh(*shape, device="cpu"), **kw)


def _pod_mesh() -> SlotMesh:
    grid = np.empty((2, 2, 2), dtype=object)
    for idx in np.ndindex(grid.shape):
        grid[idx] = torch.device("cpu")
    return SlotMesh(grid, ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# make_policy
# ---------------------------------------------------------------------------

_POLICY_MESHES = [(1, 1), (2, 2), (1, 4), (2, 4), (1, 8), (16, 16), (2, 16, 16)]


def _policy_configs():
    from repro.configs import ARCHITECTURES, fedlm_100m, get_config, housing_mlp
    from repro_torch.configs import fedlm_100m as tfedlm
    from repro_torch.configs import housing_mlp as thousing

    pairs = {a: (get_config(a), tget_config(a)) for a in ARCHITECTURES}
    pairs["fedlm-100m"] = (fedlm_100m.config(), tfedlm.config())
    pairs["housing-mlp"] = (housing_mlp.config(), thousing.config())
    return pairs


_FIELDS = ("data_axes", "model_axis", "shard_q_heads", "shard_kv_heads", "shard_ssm_heads",
           "fsdp_params", "seq_parallel", "serving")


def _outcome(make, cfg, shape, **kw):
    """``make_policy``'s fields on a mesh of ``shape`` (the reference reads
    only its ``shape``), or the exception's type it raises."""
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    mesh = types.SimpleNamespace(shape=dict(zip(names, shape)))
    try:
        pol = make(cfg, mesh, multi_pod=len(shape) == 3, **kw)
    except Exception as e:  # housing-mlp has no heads: the reference raises
        return type(e).__name__
    return (pol.active, pol.model_size, pol.batch_spec(3)[0], pol.fsdp_axes(),
            *(getattr(pol, f) for f in _FIELDS))


@pytest.mark.parametrize("arch", list(_policy_configs()))
def test_make_policy_fields_equal_the_references(arch):
    """For every registered arch, fedlm-100m and housing-mlp, on seven
    meshes (the multi-pod one included), ``fsdp`` None/True/False and
    ``serving`` both ways: the same fields, ``active``, ``model_size``, batch
    spec and FSDP axes (or the same exception), and no policy without a mesh."""
    from repro.models.sharding import make_policy as jmake_policy

    jcfg, tcfg = _policy_configs()[arch]
    for shape in _POLICY_MESHES:
        for fsdp in (None, True, False):
            for serving in (False, True):
                want = _outcome(jmake_policy, jcfg, shape, fsdp=fsdp, serving=serving)
                got = _outcome(tsharding.make_policy, tcfg, shape, fsdp=fsdp, serving=serving)
                assert got == want, (arch, shape, fsdp, serving)
    none, jnone = tsharding.make_policy(tcfg, None), jmake_policy(jcfg, None)
    assert not none.active and not jnone.active
    assert [getattr(none, f) for f in _FIELDS] == [getattr(jnone, f) for f in _FIELDS]
    assert none.model_size == jnone.model_size == 1


def test_policy_on_a_slot_mesh():
    """``make_debug_mesh`` gives a ``("data", "model")`` grid on one device;
    the policy's slot grid is ``(data slots, model slots)``, the pod mesh's
    data slots row-major over ``("pod", "data")``."""
    mesh = make_debug_mesh(2, 4, device="cpu")
    assert mesh.axis_names == ("data", "model") and dict(mesh.shape) == {"data": 2, "model": 4}
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    pol = tsharding.make_policy(tget_reduced("gemma3-4b"), mesh)
    assert pol.active and pol.model_size == 4 and not pol.shard_kv_heads
    assert tsharding.slot_grid(pol).shape == (2, 4)
    pod = tsharding.make_policy(tget_reduced("qwen3-14b"), _pod_mesh(), multi_pod=True)
    assert pod.data_axes == ("pod", "data") and tsharding.slot_grid(pod).shape == (4, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the card by default, never the host silently
            make_debug_mesh(1, 2)


# ---------------------------------------------------------------------------
# apply_moe_ep
# ---------------------------------------------------------------------------


def _expert_outputs(p: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Each token's top-k routes' gated expert outputs ``(T, k, D)`` (every
    expert on every token, as the dense MoE) and the shared MLP's ``(T, D)``."""
    xf = x.reshape(-1, x.shape[-1])
    _, gates, idx = tlayers._router_probs(p, xf, cfg)
    h = torch.einsum("td,edf->tef", xf, p["we_gate"])
    u = torch.einsum("td,edf->tef", xf, p["we_up"])
    eo = torch.einsum("tef,efd->ted", torch.nn.functional.silu(h) * u, p["we_down"])
    routed = torch.take_along_dim(eo, idx[..., None], dim=1) * gates[..., None]
    shared = (tlayers.apply_mlp(p["shared"], x, cfg).reshape(xf.shape) if "shared" in p
              else torch.zeros_like(xf))
    return routed, shared


@pytest.mark.parametrize("cfg_name,mesh,fsdp", _MOE_CASES)
def test_moe_ep_matches_the_references(reference, cfg_name, mesh, fsdp):
    """The dispatch body on (2, 2) and (1, 2), FSDP or not, on
    ``test_multidevice``'s MoE and on reduced qwen2-moe and deepseek-v3: the
    output within 1e-5 of its largest value, the aux loss (the reference's
    data slot 0's) within 1e-6 and, over two data slots, its gradient with
    respect to the router (the mean's over the data slots) within 1e-5 of
    its largest value, and the same kept assignments: the reference's
    output rebuilt from the port's kept routes, where each dropped route's
    output would show."""
    cfg = _tcfg(cfg_name)
    p = _carry(reference, f"moe.{cfg_name}", tlayers.init_moe(torch.Generator(), cfg))
    x = torch.from_numpy(_inputs()[f"moe.{cfg_name}.x"])
    pol = _policy(cfg, mesh, fsdp=fsdp)
    key = f"moe.{cfg_name}.{mesh[0]}x{mesh[1]}.{fsdp}"
    want_y, want_aux = reference[key + ".y"], reference[key + ".aux"]
    with torch.no_grad():
        y, aux = tlayers.apply_moe_ep(p, x, cfg, pol)
        kept = tlayers.moe_ep_kept(p, x, cfg, pol)
        routed, shared = _expert_outputs(p, x, cfg)
    scale = float(np.abs(want_y).max())
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(aux.numpy(), want_aux, rtol=0, atol=1e-6)
    rebuilt = (routed * kept[..., None]).sum(dim=1) + shared
    np.testing.assert_allclose(rebuilt.numpy(), want_y.reshape(rebuilt.shape), rtol=0,
                               atol=1e-5 * scale)
    if mesh == (2, 2):
        grad = torch.func.grad(lambda r: tlayers.apply_moe_ep({**p, "router": r}, x, cfg,
                                                              pol)[1])(p["router"])
        want_grad = reference[key + ".aux_grad"]
        np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0,
                                   atol=1e-5 * float(np.abs(want_grad).max()))
    dropped = routed[~kept]
    if len(dropped):
        assert float(dropped.abs().amax(dim=-1).min()) > 1e-3 * scale
    if cfg_name != "t" and mesh == (2, 2):
        assert int((~kept).sum()) > 0  # capacity drops routes here
    if cfg_name == "t":
        assert bool(kept.all())  # capacity_factor 4 keeps every route


def test_moe_ep_aux_is_data_slot_0s_with_the_means_gradient():
    """The aux loss of the dispatch body: data slot 0's value, the gradient
    of the mean over the data slots (what the reference's ``out_specs=P()``
    gives, forward and backward)."""
    cfg = _tcfg("qwen2-moe-a2.7b")
    p = tlayers.init_moe(torch.Generator().manual_seed(1), cfg)
    x = torch.randn((4, 8, cfg.d_model), generator=torch.Generator().manual_seed(2))
    pol = _policy(cfg, (2, 2))

    def per_block(router):
        out = []
        for xb in x.split(2):
            probs, _, idx = tlayers._router_probs({"router": router},
                                                  xb.reshape(-1, cfg.d_model), cfg)
            out.append(tlayers.moe_aux_loss(probs, idx, cfg))
        return out

    aux = tlayers.apply_moe_ep(p, x, cfg, pol)[1]
    blocks = per_block(p["router"])
    assert float(aux) == float(blocks[0]) and float(blocks[0]) != float(blocks[1])
    got = torch.func.grad(lambda r: tlayers.apply_moe_ep({**p, "router": r}, x, cfg, pol)[1])(
        p["router"])
    want = torch.func.grad(lambda r: sum(per_block(r)) / 2)(p["router"])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# decodes under a policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(_DECODES))
def test_sharded_decode_matches_the_references(reference, name):
    """Each step's logits under the policy against the reference's decode
    with the same policy, within 1e-5 (f32): ``_flash_decode`` on reduced
    gemma3-4b over (1, 4) and (2, 4) through 40 positions (its 16-slot rings
    wrap twice) and qwen3-14b; MLA's sharded decode and the 2-D EP decode on
    deepseek-v3 over (2, 2) with FSDP and serving; the 2-D EP decode on
    qwen2-moe.  The final caches within 1e-5, every cache leaf written in
    place (its ``data_ptr`` fixed)."""
    arch, mesh, kw, B, S, L = _DECODES[name]
    cfg = _tcfg(arch)
    params = _params(reference, f"decode.{name}", cfg)
    pol = _policy(cfg, mesh, **kw)
    tokens = torch.from_numpy(_inputs()[f"decode.{name}.tokens"])
    cache = tkv.init_cache(cfg, B, L, dtype=torch.float32, device="cpu")
    ptrs = [t.data_ptr() for t in flatten(cache)[0]]
    logits = torch.cat([ttf.decode_step(params, tokens[:, t:t + 1], cache, t, cfg,
                                        policy=pol)[0] for t in range(S)], dim=1)
    np.testing.assert_allclose(logits.numpy(), reference[f"decode.{name}.logits"], rtol=0,
                               atol=1e-5)
    leaves = flatten(cache)[0]
    assert [t.data_ptr() for t in leaves] == ptrs
    for i, leaf in enumerate(leaves):
        np.testing.assert_allclose(leaf.numpy(), reference[f"decode.{name}.cache{i}"], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("name", list(_DECODES))
def test_sharded_decode_takes_the_sharded_paths(name, monkeypatch):
    """Under each policy the decode takes the reference's sharded paths: every
    attention layer the flash or MLA sharded decode, every routed layer the
    2-D EP decode (where the policy does not shard the KV heads)."""
    arch, mesh, kw, B, S, L = _DECODES[name]
    cfg = _tcfg(arch)
    pol = _policy(cfg, mesh, **kw)
    seen = {"flash": 0, "mla": 0, "ep_decode": 0}
    for fn, key in (("_flash_decode", "flash"), ("_mla_sharded_decode", "mla"),
                    ("_moe_ep_decode", "ep_decode")):
        real = getattr(tlayers, fn)
        monkeypatch.setattr(tlayers, fn, lambda *a, _r=real, _k=key, **k: (
            seen.__setitem__(_k, seen[_k] + 1), _r(*a, **k))[1])
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    cache = tkv.init_cache(cfg, B, L, dtype=torch.float32, device="cpu")
    ttf.decode_step(params, torch.zeros((B, 1), dtype=torch.int64), cache, 0, cfg, policy=pol)
    n_layers = cfg.n_layers
    routed = sum(s.moe for s in cfg.layer_specs())
    want = {"flash": 0 if cfg.attn_impl == "mla" or pol.shard_kv_heads else n_layers,
            "mla": n_layers if cfg.attn_impl == "mla" else 0, "ep_decode": routed}
    assert seen == want


# ---------------------------------------------------------------------------
# the steps under a policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", _TRAIN_ARCHS)
def test_pod_policy_train_step_matches_the_references(reference, arch):
    """``make_train_step`` under the ``("pod", "data", "model")`` (2, 2, 2)
    policy with FSDP (qwen2-moe through the EP dispatch body, its gradient
    under ``torch.func.grad_and_value``): the loss within 1e-5 relative, every
    updated parameter within 1e-5 of the reference's."""
    cfg = _tcfg(arch)
    params = _params(reference, f"train.{arch}", cfg)
    pol = tsharding.make_policy(cfg, _pod_mesh(), multi_pod=True, fsdp=True)
    tokens = torch.from_numpy(_inputs()[f"train.{arch}.tokens"])
    opt = topt.sgd(_TRAIN_LR)
    new, _, loss = tsteps.make_train_step(cfg, opt, pol)(
        params, opt.init(params), {"tokens": tokens, "labels": tokens})
    want = float(reference[f"train.{arch}.loss"])
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    for i, leaf in enumerate(flatten(new)[0]):
        np.testing.assert_allclose(leaf.detach().numpy(), reference[f"train.{arch}.new{i}"],
                                   rtol=0, atol=1e-5)


def test_sharded_serve_step_tokens_equal_the_references(reference):
    """``make_serve_step`` with a sharded cache (reduced gemma3-4b, (2, 4),
    every layer's flash decode), greedy from token 0: the reference's tokens."""
    arch, mesh, B, steps, L = _SERVE
    cfg = _tcfg(arch)
    params = _params(reference, "serve", cfg)
    step = tsteps.make_serve_step(cfg, _policy(cfg, mesh))
    cache = tkv.init_cache(cfg, B, L, dtype=torch.float32, device="cpu")
    tok, toks = torch.zeros((B, 1), dtype=torch.int64), []
    for t in range(steps):
        tok, cache = step(params, cache, tok, t)
        toks.append(tok)
    np.testing.assert_array_equal(torch.cat(toks, dim=1).numpy(), reference["serve.tokens"])


def test_sharded_prefill_step_tokens_equal_the_references(reference):
    """``make_prefill_step`` under a (2, 2) policy (reduced qwen2-moe through
    the EP dispatch body) and without: the reference's next tokens."""
    arch, mesh, _ = _PREFILL
    cfg = _tcfg(arch)
    params = _params(reference, "prefill", cfg)
    batch = {"tokens": torch.from_numpy(_inputs()["prefill.tokens"])}
    got = tsteps.make_prefill_step(cfg, _policy(cfg, mesh))(params, batch)
    np.testing.assert_array_equal(got.numpy(), reference["prefill.next"])
    np.testing.assert_array_equal(tsteps.make_prefill_step(cfg)(params, batch).numpy(),
                                  reference["prefill.next_unsharded"])


def test_whisper_prefill_step_passes_frames_like_the_references():
    """The prefill repair: ``make_prefill_step`` on reduced whisper-large-v3
    passes the batch's ``frames`` to the forward; from the reference's
    weights and the same frames and tokens, the next tokens equal the
    reference's ``make_prefill_step``'s (before the repair the port raised
    ``AssertionError: enc-dec model needs frames or memory``)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jget_reduced
    from repro.launch.steps import make_prefill_step as jmake_prefill_step
    from repro.models import transformer as jtf

    jcfg = dataclasses.replace(jget_reduced("whisper-large-v3"), dtype=jnp.float32)
    cfg = _tcfg("whisper-large-v3")
    jparams = jtf.init_params(jax.random.key(13), jcfg)
    params = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(17)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12))
    frames = rng.standard_normal((2, cfg.encoder_seq_len, cfg.frontend_dim), dtype=np.float32)
    want = jax.jit(jmake_prefill_step(jcfg))(jparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                                                       "frames": jnp.asarray(frames)})
    got = tsteps.make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(tokens),
                                                 "frames": torch.from_numpy(frames)})
    assert got.dtype == torch.int32 and tuple(got.shape) == (2,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the one-device path
# ---------------------------------------------------------------------------


def test_constrain_returns_the_very_tensor():
    x = torch.randn(2, 8, 4)
    pol = _policy(tget_reduced("gemma3-4b"), (2, 4))
    for policy in (None, tsharding.ShardingPolicy(mesh=None), pol):
        assert tsharding.constrain(x, policy, ("data",), None, "model") is x
        assert tsharding.seq_constrain(x, policy) is x


@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-v3-671b", "qwen2-moe-a2.7b",
                                  "zamba2-1.2b", "whisper-large-v3"])
def test_no_policy_is_the_one_device_path_bit_for_bit(arch):
    """Without a policy, with ``policy=None`` and with an inactive one: the
    forward, the loss and a decode step give the same bits."""
    cfg = _tcfg(arch)
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(19)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq_len, cfg.frontend_dim), dtype=np.float32))
    runs = []
    for kw in ({}, {"policy": None}, {"policy": tsharding.ShardingPolicy(mesh=None)}):
        with torch.no_grad():
            logits = ttf.forward(params, tokens, cfg, frames=batch.get("frames"), **kw)[0]
            loss = ttf.lm_loss(params, batch, cfg, **kw)
            memory = (ttf.encode(params, batch["frames"], cfg, **kw)
                      if cfg.is_encoder_decoder else None)
            cache = tkv.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
            step = ttf.decode_step(params, tokens[:, :1], cache, 0, cfg, memory=memory, **kw)[0]
        runs.append((logits, loss, step))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)
