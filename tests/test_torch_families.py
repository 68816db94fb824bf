"""MoE, MLA, multi-token prediction, Mamba2, the zamba2 hybrid and the whisper
encoder-decoder, module by module, against the reference.

Inputs come from numpy with a seed; the reference runs under ``jax.jit`` on
the CPU (its layers eagerly), the port on the CPU, on the reference's weights
carried across with ``core/packing.tree_from_numpy``.  The bars:

* layers in f32: atol = rtol = 1e-5 (the two frameworks' CPU BLAS sum in
  different orders); the MLA naive and chunked paths also against each other
  at the reference's own atol 3e-5 (``test_mla_chunked_matches_naive``);
  router indices and the padded experts exactly;
* whole models, at the dense family's bars (``tests/test_torch_models.py``
  ``_BARS``): f32 logits 1e-5, loss 1e-5, every gradient leaf 1e-4 of its
  largest magnitude; bf16 logits 0.1, loss 5e-4 relative, gradients 0.1.
  Measured worst cases over the five families against the jitted
  reference: f32 7.2e-6, 1.5e-7 and 4.6e-6; bf16 0.059, 1.5e-4 and 0.038
  (zamba2 and whisper).  Every MoE route agrees in
  f32; in bf16 two tokens of reduced deepseek-v3 take other experts in the
  port than in the jitted reference, and the test compares around them
  (``test_forward_loss_and_gradients_match_reference``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.models as jmodels
import repro_torch.core as tcore
import repro_torch.models as tmodels
from repro.configs import ARCHITECTURES as J_ARCHS
from repro.configs import get_reduced as jget_reduced
from repro.configs import housing_mlp as jhousing
from repro.configs.fedlm_100m import config as jfedlm
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.configs import housing_mlp as thousing
from repro_torch.configs.fedlm_100m import config as tfedlm
from repro_torch.core import packing as tpack
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.tree import flatten

FAMILIES = ("qwen2-moe-a2.7b", "deepseek-v3-671b", "mamba2-780m", "zamba2-1.2b",
            "whisper-large-v3")
_DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}
_BARS = {"float32": dict(logits=1e-5, loss=1e-5, grad=1e-4),
         "bfloat16": dict(logits=0.1, loss=5e-4, grad=0.1)}
TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _pair(**fields):
    """The same hand-made config in both packages, f32 compute."""
    return (JModelConfig(**fields, dtype=jnp.float32),
            TModelConfig(**fields, dtype=torch.float32))


def _carry(jp):
    return tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

# Nothing of the reference's core is owed any more (the column-sharded arena
# came with slice G-1); the port's own helpers: the weights carried across to
# and from numpy, and the mask-aware normalization its kernels share.
_SHARDED: set[str] = set()
_PORT_ONLY = {"tree_from_numpy", "tree_to_numpy", "masked_normalize"}


def test_core_exports_the_references_names():
    assert set(jcore.__all__) - _SHARDED == set(tcore.__all__) - _PORT_ONLY
    assert all(hasattr(tcore, name) for name in tcore.__all__)
    from repro_torch.core import Int8UploadCodec
    from repro_torch.core.transport import Int8UploadCodec as defined

    assert Int8UploadCodec is defined


def test_models_export_what_is_ported():
    assert tmodels.__all__ == ["ModelConfig", "plan_segments", "layers", "transformer",
                               "kvcache", "mlp", "sharding"]
    assert set(jmodels.__all__) == set(tmodels.__all__)
    from repro_torch.models import sharding

    assert tmodels.sharding is sharding and "arena_specs" in sharding.__all__
    # the model axis (slice G-2): the reference's four names and seq_constrain
    from repro.models import sharding as jsharding

    assert set(jsharding.__all__) | {"seq_constrain"} <= set(sharding.__all__)
    assert all(callable(getattr(sharding, n)) for n in sharding.__all__)
    assert {"apply_moe_ep", "apply_moe"} <= set(tlayers.__all__)
    from repro_torch.launch import mesh as tmesh

    assert "make_debug_mesh" in tmesh.__all__ and callable(tmesh.make_debug_mesh)
    assert tmodels.transformer is ttf and tmodels.layers is tlayers and tmodels.mlp is tmlp
    from repro_torch.models import kvcache

    assert tmodels.kvcache is kvcache
    assert tmodels.ModelConfig is TModelConfig


# ---------------------------------------------------------------------------
# MoE layers
# ---------------------------------------------------------------------------


def _moe_pair(shared: bool, pad: bool = False):
    return _pair(name="t", arch_type="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
                 d_ff=64, vocab_size=100, n_experts=3 if pad else 6,
                 expert_pad_to=4 if pad else 1, top_k=2, moe_d_ff=48,
                 n_shared_experts=1 if shared else 0, shared_d_ff=40 if shared else 0)


def _moe_params(jcfg, seed=0):
    jp = jlayers.init_moe(jax.random.key(seed), jcfg)
    # spread the router so the routes are far from ties
    jp["router"] = jp["router"] * 20.0
    return jp, _carry(jp)


@pytest.mark.parametrize("pad", [False, True])
def test_router_probs_match_reference(pad):
    """Probabilities and renormalized gates at 1e-5; the chosen experts
    equal, in the same order (``lax.top_k``'s)."""
    jcfg, tcfg = _moe_pair(shared=False, pad=pad)
    jp, tp = _moe_params(jcfg, 1)
    x = _rng(1).normal(size=(40, 32)).astype(np.float32)
    jprobs, jgates, jidx = jlayers._router_probs(jp, jnp.asarray(x), jcfg)
    tprobs, tgates, tidx = tlayers._router_probs(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(tprobs), np.asarray(jprobs), **TOL)
    np.testing.assert_allclose(_np(tgates), np.asarray(jgates), **TOL)
    assert tprobs.dtype == tgates.dtype == torch.float32
    np.testing.assert_allclose(tgates.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_router_ties_go_to_the_lower_index():
    """Equal probabilities: ``lax.top_k`` takes the lowest index first, and
    so does the port's stable sort (``torch.topk`` promises no order)."""
    jcfg, tcfg = _moe_pair(shared=False)
    router = np.zeros((32, 6), np.float32)
    x = _rng(2).normal(size=(5, 32)).astype(np.float32)
    _, _, jidx = jlayers._router_probs({"router": jnp.asarray(router)}, jnp.asarray(x), jcfg)
    _, _, tidx = tlayers._router_probs({"router": torch.from_numpy(router)},
                                       torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert (tidx.numpy() == [0, 1]).all()


def test_padded_experts_never_routed():
    """The reference's ``test_moe_padded_experts_never_routed``: 3 experts
    padded to 4, the pad at ``-1e30``, zero probability, never chosen."""
    jcfg, tcfg = _moe_pair(shared=False, pad=True)
    assert tcfg.padded_n_experts == 4
    jp = jlayers.init_moe(jax.random.key(0), jcfg)
    tp = _carry(jp)
    x = _rng(3).normal(size=(32, 32)).astype(np.float32)
    probs, _, idx = tlayers._router_probs(tp, torch.from_numpy(x), tcfg)
    assert int(idx.max()) < 3
    assert float(probs[:, 3].abs().max()) == 0.0
    _, _, jidx = jlayers._router_probs(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_moe_aux_loss_matches_reference():
    jcfg, tcfg = _moe_pair(shared=False)
    r = _rng(4)
    probs = r.dirichlet(np.ones(6), size=50).astype(np.float32)
    idx = np.stack([r.permutation(6)[:2] for _ in range(50)]).astype(np.int32)
    want = jlayers.moe_aux_loss(jnp.asarray(probs), jnp.asarray(idx), jcfg)
    got = tlayers.moe_aux_loss(torch.from_numpy(probs), torch.from_numpy(idx.astype(np.int64)),
                               tcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # Only the probabilities carry a gradient: d aux / d probs = E f / T.
    tprobs = torch.from_numpy(probs).requires_grad_()
    tlayers.moe_aux_loss(tprobs, torch.from_numpy(idx.astype(np.int64)), tcfg).backward()
    jgrad = jax.grad(lambda p: jlayers.moe_aux_loss(p, jnp.asarray(idx), jcfg))(
        jnp.asarray(probs))
    np.testing.assert_allclose(tprobs.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("shared", [False, True])
def test_apply_moe_dense_matches_reference(shared):
    """Output and aux loss; every expert on every token, the shared
    experts' dense MLP added.  ``apply_moe`` is the dense path on one device."""
    jcfg, tcfg = _moe_pair(shared=shared)
    jp, tp = _moe_params(jcfg, 5)
    assert ("shared" in tp) == shared
    x = _rng(5).normal(size=(2, 9, 32)).astype(np.float32)
    jy, jaux = jlayers.apply_moe_dense(jp, jnp.asarray(x), jcfg)
    ty, taux = tlayers.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # An unchosen expert's NaN reaches the output as NaN * 0, as in the reference.
    tp["we_down"][5] = float("nan")
    ty, _ = tlayers.apply_moe_dense(tp, torch.from_numpy(x), tcfg)
    jp["we_down"] = jp["we_down"].at[5].set(jnp.nan)
    jy, _ = jlayers.apply_moe_dense(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(np.isnan(_np(ty)), np.isnan(np.asarray(jy)))
    assert np.isnan(_np(ty)).all()


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla_pair(chunk_min_len: int, **over):
    # The reference's test_mla_chunked_matches_naive config.
    fields = dict(name="t", arch_type="dense", n_layers=1, d_model=64, n_heads=4, n_kv_heads=4,
                  d_ff=128, vocab_size=100, attn_impl="mla", q_lora_rank=24, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                  attn_chunk_min_len=chunk_min_len, attn_k_chunk=33)
    return _pair(**{**fields, **over})


@pytest.mark.parametrize("chunked", [False, True])
def test_apply_mla_matches_reference(chunked):
    """Latent q and kv, the rope key shared across heads, value heads of
    ``v_head_dim`` (16) beside q/k heads of nope + rope (24), scale
    1/sqrt(24); 100 keys in chunks of 33 (a padded last chunk)."""
    jcfg, tcfg = _mla_pair(1 if chunked else 2048)
    assert tlayers._use_chunked(tcfg, 100, 100) == chunked
    jp = jlayers.init_mla(jax.random.key(2), jcfg)
    tp = _carry(jp)
    x = _rng(6).normal(size=(2, 100, 64)).astype(np.float32)
    pos = np.arange(100)[None, :].repeat(2, 0)
    jy, _ = jlayers.apply_mla(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                              mode="causal")
    ty, cache = tlayers.apply_mla(tp, torch.from_numpy(x), tcfg,
                                  positions=torch.from_numpy(pos), mode="causal")
    assert cache is None
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)


def test_mla_chunked_matches_naive():
    """The reference's own equivalence, on the port, at its atol 3e-5."""
    _, tcfg = _mla_pair(1)
    jp = jlayers.init_mla(jax.random.key(2), _mla_pair(1)[0])
    tp = _carry(jp)
    x = torch.from_numpy(_rng(7).normal(size=(2, 100, 64)).astype(np.float32))
    pos = torch.arange(100)[None, :].repeat(2, 1)
    yc, _ = tlayers.apply_mla(tp, x, tcfg, positions=pos, mode="causal")
    yn, _ = tlayers.apply_mla(tp, x, dataclasses.replace(tcfg, attn_naive=True), positions=pos,
                              mode="causal")
    np.testing.assert_allclose(yc.numpy(), yn.numpy(), atol=3e-5)


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-72b"])
def test_cross_attention_matches_reference(arch, chunked):
    """Queries from 7 decoder positions, keys and values from 19 memory
    rows: no RoPE (``qwen2-72b``'s rope config, with qkv bias and GQA),
    mode ``"full"``, naive and in chunks of 8."""
    over = dict(attn_k_chunk=8, attn_chunk_min_len=8 if chunked else 2048)
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(tget_reduced(arch), dtype=torch.float32, **over)
    jp = jlayers.init_attention(jax.random.key(8), jcfg, cross=True)
    jp = {k: v + 0.1 if k.startswith("b") else v for k, v in jp.items()}
    tp = _carry(jp)
    r = _rng(8)
    x = r.normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    mem = r.normal(size=(2, 19, jcfg.d_model)).astype(np.float32)
    pos = np.arange(7)[None, :]
    jy, _ = jlayers.apply_attention(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                    mode="full", x_cross=jnp.asarray(mem))
    ty, _ = tlayers.apply_attention(tp, torch.from_numpy(x), tcfg,
                                    positions=torch.from_numpy(pos), mode="full",
                                    x_cross=torch.from_numpy(mem))
    assert ty.shape == (2, 7, jcfg.d_model)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def _ssm_pair(chunk: int = 8):
    # The reference's test_ssd_chunked_matches_sequential config.
    return _pair(name="t", arch_type="ssm", n_layers=1, d_model=64, n_heads=4, n_kv_heads=4,
                 d_ff=0, vocab_size=100, ssm_state=16, ssm_head_dim=16, ssm_chunk=chunk)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_causal_conv_matches_reference(dtype):
    jdt, tdt = _DTYPES[dtype]
    r = _rng(9)
    x = r.normal(size=(2, 11, 20)).astype(np.float32)
    w = (r.normal(size=(4, 20)) * 0.3).astype(np.float32)
    b = r.normal(size=(20,)).astype(np.float32)
    want = jlayers._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b))
    got = tlayers._causal_conv(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                               torch.from_numpy(b))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _ssd_inputs(B, S, H, Pd, N, seed):
    r = _rng(seed)
    xh = r.normal(size=(B, S, H, Pd)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(B, S, H)) - 1.0)).astype(np.float32)  # softplus
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H))).astype(np.float32)
    Bm = r.normal(size=(B, S, N)).astype(np.float32)
    Cm = r.normal(size=(B, S, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm


def _ssd_sequential(xh, dt, A, Bm, Cm):
    """The recurrence the chunked scan computes, one step at a time, in f64:
    ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t``, ``y_t = h_t C_t``."""
    B, S, H, Pd = xh.shape
    h = np.zeros((B, H, Pd, Bm.shape[-1]))
    ys = []
    for t in range(S):
        h = (h * np.exp(dt[:, t] * A)[:, :, None, None]
             + np.einsum("bh,bhp,bn->bhpn", dt[:, t], xh[:, t], Bm[:, t]))
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return np.stack(ys, axis=1)


@pytest.mark.parametrize("S,chunk", [(37, 8), (16, 8), (5, 8), (40, 64)])
def test_ssd_chunked_matches_reference_and_the_sequential_scan(S, chunk):
    """Several chunks plus a padded tail (37 in chunks of 8), whole chunks,
    one short chunk, one chunk.  Against the reference's ``_ssd_chunked`` at
    1e-5, and against the step-by-step recurrence in f64 at the atol 1e-3
    of the reference's ``test_ssd_chunked_matches_sequential`` (which holds
    its chunked scan against its decode path; the port's decode path is held
    so in ``tests/test_torch_decode.py``)."""
    args = _ssd_inputs(2, S, 3, 4, 5, seed=S)
    want = jlayers._ssd_chunked(*map(jnp.asarray, args), chunk)
    got = tlayers._ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert got.shape == (2, S, 3, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = _ssd_sequential(*(a.astype(np.float64) for a in args))
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-3)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_apply_mamba_matches_reference(dtype):
    """The mixer over 37 positions in chunks of 8: in-projection, conv, SSD,
    the D skip, the gated RMS norm in f32, out-projection."""
    jdt, tdt = _DTYPES[dtype]
    jcfg, tcfg = _ssm_pair()
    jcfg, tcfg = dataclasses.replace(jcfg, dtype=jdt), dataclasses.replace(tcfg, dtype=tdt)
    jp = jlayers.init_mamba(jax.random.key(0), jcfg)
    tp = _carry(jp)
    init = tlayers.init_mamba(torch.Generator().manual_seed(0), tcfg)
    for name in ("A_log", "D_skip", "dt_bias", "norm", "conv_b"):
        np.testing.assert_allclose(init[name].numpy(), np.asarray(jp[name]), rtol=1e-6,
                                   err_msg=name)
    x = _rng(10).normal(size=(2, 37, 64)).astype(np.float32)
    jy, _ = jax.jit(lambda p, x_: jlayers.apply_mamba(p, x_, jcfg))(jp, jnp.asarray(x, jdt))
    ty, cache = tlayers.apply_mamba(tp, torch.from_numpy(x).to(tdt), tcfg)
    assert cache is None and ty.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 0.1
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _abstract_specs(jparams):
    leaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    return [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype)) for p, x in leaves]


_MANIFESTS = tuple(J_ARCHS) + ("fedlm-100m", "housing-mlp-10m")


@pytest.mark.parametrize("arch", _MANIFESTS)
def test_manifest_equals_the_references_abstract_params(arch):
    """Names, shapes, dtypes and offsets of every leaf: each arch's reduced
    configuration, fedlm-100m and housing-mlp-10m at full size."""
    if arch == "housing-mlp-10m":
        want = _abstract_specs(jax.eval_shape(
            lambda: jmlp.init_params(jax.random.key(0), jhousing.config("10m"))))
        params = tmlp.init_params(torch.Generator().manual_seed(0), thousing.config("10m"), "cpu")
    else:
        jcfg, tcfg = (jfedlm(), tfedlm()) if arch == "fedlm-100m" else (
            jget_reduced(arch), tget_reduced(arch))
        want = _abstract_specs(jtf.abstract_params(jcfg))
        params = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    manifest = tpack.build_manifest(params)
    assert [(s.name, s.shape, s.dtype) for s in manifest.specs] == want
    offsets = np.cumsum([0] + [math.prod(shape) for _, shape, _ in want])[:-1]
    assert [s.offset for s in manifest.specs] == offsets.tolist()
    if "segments" in params:
        assert isinstance(params["segments"], list)
        assert all(isinstance(seg, tuple) for seg in params["segments"])


def _case(arch, dtype):
    """(reference cfg, port cfg, reference params, port params, numpy batch)."""
    jdt, tdt = _DTYPES[dtype]
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jdt)
    tcfg = dataclasses.replace(tget_reduced(arch), dtype=tdt)
    jp = jtf.init_params(jax.random.key(0), jcfg)
    tp = _carry(jp)
    r = _rng(5)
    batch = {"tokens": r.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32),
             "labels": r.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)}
    if jcfg.is_encoder_decoder:  # whisper's audio_stub: frames for the encoder
        batch["frames"] = r.normal(
            size=(2, jcfg.encoder_seq_len, jcfg.frontend_dim)).astype(np.float32)
    return jcfg, tcfg, jp, tp, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


def _jit_with_routes(fn, *args):
    """``jax.jit(fn)(*args)`` and every MoE layer's chosen experts in that
    very program, in layer order (a debug callback on the router's indices)."""
    routes, real = [], jlayers._router_probs

    def spy(p, x_flat, cfg):
        out = real(p, x_flat, cfg)
        jax.debug.callback(lambda idx: routes.append(np.asarray(idx)), out[2])
        return out

    jlayers._router_probs = spy
    try:
        out = jax.block_until_ready(jax.jit(fn)(*args))
    finally:
        jlayers._router_probs = real
    return out, routes


def _torch_with_routes(fn, *args):
    """``fn(*args)`` on the port and every MoE layer's chosen experts."""
    routes, real = [], tlayers._router_probs

    def spy(p, x_flat, cfg):
        out = real(p, x_flat, cfg)
        routes.append(out[2].numpy().copy())
        return out

    tlayers._router_probs = spy
    try:
        out = fn(*args)
    finally:
        tlayers._router_probs = real
    return out, routes


def _agreeing_tokens(troutes, jroutes, n_tokens):
    """(n_tokens,) bool: the tokens routed alike in every MoE layer."""
    assert len(troutes) == len(jroutes)
    ok = np.ones((n_tokens,), bool)
    for t, j in zip(troutes, jroutes):
        ok &= (t == j).all(axis=-1)
    return ok


def _masked_xent(logits, labels, keep, lib):
    """Mean next-token cross-entropy in f32 over the tokens ``keep`` marks."""
    if lib is torch:
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.take_along_dim(logp, labels[..., None], dim=-1)[..., 0].reshape(-1)
        return -(ll * torch.from_numpy(keep)).sum() / keep.sum()
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    ll = jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0].reshape(-1)
    return -(ll * keep).sum() / keep.sum()


def _assert_grads_close(tgrads, jgrads, bar):
    jleaves, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    tleaves = flatten(tgrads)[0]
    assert len(jleaves) == len(tleaves)
    for (path, want), got in zip(jleaves, tleaves):
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(got.numpy() - want).max()) / scale
        assert err <= bar, (jax.tree_util.keystr(path), err)


# bf16 MoE: the fewest of the 48 tokens whose routes must agree with the
# jitted reference's.  In reduced deepseek-v3's MoE layer the port routes
# token 12 otherwise than the reference (jitted and eager alike), and the
# reference routes token 27 otherwise jitted than eager.
_MIN_AGREEING = {"qwen2-moe-a2.7b": 48, "deepseek-v3-671b": 46}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_loss_and_gradients_match_reference(arch, dtype):
    """Logits, ``lm_loss`` (with the MoE aux and MTP terms) and every
    gradient leaf, at the dense family's bars.  The MoE aux loss at 1e-5 relative in
    f32 and 5e-3 in bf16 (the reference jitted and eager differ by 1e-3).

    MoE in bf16: the two packages round at other places, and a token whose
    top-k sits near a tie can take another expert (every route agrees in
    f32).  Where one does, the bf16 case compares on the tokens routed
    alike, at least ``_MIN_AGREEING``: their logits, and the next-token
    cross-entropy over them with its every gradient leaf (a flipped token's
    MoE output reaches only its own logits: the MoE is its layer's last
    block).  The full loss, the aux and the MTP term then hold in f32 only.
    """
    jcfg, tcfg, jp, tp, batch = _case(arch, dtype)
    bars = _BARS[dtype]
    tb = _torch_batch(batch)
    B, S = batch["tokens"].shape
    (jlogits, _, jaux), jroutes = _jit_with_routes(
        lambda p, b: jtf.forward(p, b["tokens"], jcfg, frames=b.get("frames")), jp, batch)
    with torch.no_grad():
        (tlogits, caches, taux), troutes = _torch_with_routes(
            lambda: ttf.forward(tp, tb["tokens"], tcfg, frames=tb.get("frames")))
    assert caches is None
    assert tlogits.dtype == tcfg.dtype and tlogits.shape == (B, S, tcfg.padded_vocab_size)
    assert len(troutes) == sum(s.moe for s in tcfg.layer_specs())
    agree = _agreeing_tokens(troutes, jroutes, B * S)
    want_agree = B * S if dtype == "float32" else _MIN_AGREEING.get(arch, B * S)
    assert agree.sum() >= want_agree, np.flatnonzero(~agree)
    V = tcfg.vocab_size
    np.testing.assert_allclose(_np(tlogits[..., :V]).reshape(B * S, V)[agree],
                               np.asarray(jlogits[..., :V], np.float32).reshape(B * S, V)[agree],
                               rtol=bars["logits"], atol=bars["logits"])
    assert (float(taux) > 0) == bool(tcfg.n_experts)

    if not agree.all():
        keep = agree.astype(np.float32)
        (jloss, jgrads), jroutes = _jit_with_routes(jax.value_and_grad(
            lambda p, b: _masked_xent(jtf.forward(p, b["tokens"], jcfg)[0], b["labels"],
                                      keep, jnp)), jp, batch)
        assert not (agree & ~_agreeing_tokens(troutes, jroutes, B * S)).any()
        tgrads, tloss = torch.func.grad_and_value(lambda p: _masked_xent(
            ttf.forward(p, tb["tokens"], tcfg)[0], tb["labels"], keep, torch))(tp)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=bars["loss"])
        _assert_grads_close(tgrads, jgrads, bars["grad"])
        return

    np.testing.assert_allclose(float(taux), float(jaux),
                               rtol=1e-5 if dtype == "float32" else 5e-3, atol=1e-7)
    (jloss, jgrads), jroutes = _jit_with_routes(
        jax.value_and_grad(lambda p, b: jtf.lm_loss(p, b, jcfg)), jp, batch)
    assert _agreeing_tokens(troutes, jroutes, B * S).all()
    tgrads, tloss = torch.func.grad_and_value(lambda p: ttf.lm_loss(p, tb, tcfg))(tp)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=bars["loss"],
                               atol=bars["loss"] if dtype == "float32" else 0)
    _assert_grads_close(tgrads, jgrads, bars["grad"])


def test_mtp_and_aux_terms_enter_the_loss_as_in_the_reference():
    """deepseek-v3's loss is the next-token cross-entropy plus
    ``router_aux_coef · aux`` plus ``0.3 ·`` the MTP head's cross-entropy:
    turning off the MTP head and the aux coefficient changes it by what the
    reference's changes."""
    jcfg, tcfg, jp, tp, batch = _case("deepseek-v3-671b", "float32")
    tb = _torch_batch(batch)
    assert tcfg.mtp_depth == 1 and tp["mtp"]["layer"]["attn"]["wq_a"].shape[0] == 1
    full = float(ttf.lm_loss(tp, tb, tcfg))
    off = dict(mtp_depth=0, router_aux_coef=0.0)
    plain = float(ttf.lm_loss(tp, tb, dataclasses.replace(tcfg, **off)))
    jfull = float(jtf.lm_loss(jp, batch, jcfg))
    jplain = float(jtf.lm_loss(jp, batch, dataclasses.replace(jcfg, **off)))
    assert full - plain > 0.1  # 0.3 x a cross-entropy near ln 512
    np.testing.assert_allclose(full - plain, jfull - jplain, rtol=1e-5)


def test_whisper_encoder_is_causal_as_the_references():
    """The reference's encoder runs every layer as ``ATTN``, hence causal
    self-attention: the memory at frame t does not see frames after t.  So
    changing the last frame changes only the last memory row, in both
    packages."""
    jcfg, tcfg, jp, tp, batch = _case("whisper-large-v3", "float32")
    frames = batch["frames"]
    moved = frames.copy()
    moved[:, -1] += 1.0
    tmem = [ttf.encode(tp, torch.from_numpy(f), tcfg) for f in (frames, moved)]
    jmem = [jtf.encode(jp, jnp.asarray(f), jcfg) for f in (frames, moved)]
    np.testing.assert_array_equal(tmem[0][:, :-1].numpy(), tmem[1][:, :-1].numpy())
    assert not torch.equal(tmem[0][:, -1], tmem[1][:, -1])
    for t, j in zip(tmem, jmem):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    with pytest.raises(AssertionError, match="enc-dec model needs frames or memory"):
        ttf.forward(tp, torch.from_numpy(batch["tokens"].astype(np.int64)), tcfg)
    logits, _, _ = ttf.forward(tp, torch.from_numpy(batch["tokens"].astype(np.int64)), tcfg,
                               memory=tmem[0])
    jlogits, _, _ = jtf.forward(jp, jnp.asarray(batch["tokens"]), jcfg, memory=jmem[0])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_zamba2_shared_block_is_tied_across_its_applications():
    """One ``shared_block`` serves every ``SHARED_ATTN`` layer, each scaled
    by its own ``adapter_scale``; its gradient sums over the applications."""
    jcfg, tcfg, jp, tp, batch = _case("zamba2-1.2b", "float32")
    n_shared = sum(s.kind == "shared_attn" for s in tcfg.layer_specs())
    assert n_shared >= 1 and "shared_block" in tp
    tb = _torch_batch(batch)
    grads = torch.func.grad(lambda p: ttf.lm_loss(p, tb, tcfg))(tp)
    assert float(grads["shared_block"]["attn"]["wq"].abs().max()) > 0
    unit = tcfg.layer_pattern.index("shared_attn")
    scale = grads["segments"][0][unit]["adapter_scale"]
    assert scale.shape == (1, tcfg.d_model) and float(scale.abs().max()) > 0
