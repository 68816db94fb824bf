"""The dense decoder family, module by module, against the reference.

Configs: every field, ``plan_segments``, ``padded_vocab_size`` and
``param_count_estimate`` equal the reference's for the ten assigned archs,
their ``reduce_config`` variants and fedlm-100m.  Init: the port's params
tree has the reference's names, shapes and dtypes leaf for leaf, and
fedlm-100m's full manifest is the reference's (11 leaves, 73,937,664
params).  Layers, forward, ``lm_loss``, its gradients and the steps are held
against the reference's functions on the same numpy inputs with the
reference's weights carried across:

* f32 (``dtype=float32``): norms, RoPE, masks and attention at atol 1e-5 /
  rtol 1e-5; logits and loss at 1e-5; every gradient leaf at 1e-4 of its
  largest magnitude (different BLAS summation orders);
* the default bf16 compute dtype: logits at atol 0.1 (three bf16 ulps at
  the logits' magnitude of about 4), loss at rtol 5e-4, every gradient leaf
  at 0.1 of its largest magnitude.  Measured worst cases over the six
  configs against the jitted reference: 0.033, 3.8e-4 and 0.031 — bf16
  rounds at other places in the two frameworks' CPU kernels (matmul output
  rounding, fused elementwise chains).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import ARCHITECTURES as J_ARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs.fedlm_100m import config as jfedlm
from repro.launch import steps as jsteps
from repro.models import config as jmcfg
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import optim as toptim
from repro_torch.configs import ARCHITECTURES as T_ARCHS
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.configs.fedlm_100m import config as tfedlm
from repro_torch.core import packing as tpack
from repro_torch.launch import steps as tsteps
from repro_torch.models import config as tmcfg
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.tree import flatten

DENSE = ("qwen3-14b", "qwen2-72b", "codeqwen1.5-7b", "gemma3-4b", "llava-next-34b")
_DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _configs(name):
    """(reference, port) config pairs by case name."""
    if name == "fedlm-100m":
        return jfedlm(), tfedlm()
    arch, _, variant = name.partition(":")
    if variant == "reduced":
        return jget_reduced(arch), tget_reduced(arch)
    return jget_config(arch), tget_config(arch)


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(np.dtype(cfg.dtype)) if not isinstance(cfg.dtype, torch.dtype) \
        else str(cfg.dtype).removeprefix("torch.")
    d["param_dtype"] = str(np.dtype(cfg.param_dtype)) \
        if not isinstance(cfg.param_dtype, torch.dtype) \
        else str(cfg.param_dtype).removeprefix("torch.")
    return d


_CASES = ["fedlm-100m"] + [f"{a}:full" for a in J_ARCHS] + [f"{a}:reduced" for a in J_ARCHS]


@pytest.mark.parametrize("name", _CASES)
def test_configs_match_reference(name):
    jcfg, tcfg = _configs(name)
    assert _fields(tcfg) == _fields(jcfg)
    assert tcfg.padded_vocab_size == jcfg.padded_vocab_size
    assert tcfg.param_count_estimate() == jcfg.param_count_estimate()
    assert [(s.unit, s.repeats) for s in tmcfg.plan_segments(tcfg)] == [
        (tuple(tmcfg.LayerSpec(u.kind, u.moe) for u in s.unit), s.repeats)
        for s in jmcfg.plan_segments(jcfg)]
    assert T_ARCHS == J_ARCHS


def _reference_specs(cfg):
    abstract = jtf.abstract_params(cfg)
    leaves, _ = jax.tree_util.tree_flatten_with_path(abstract)
    return [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype)) for p, x in leaves]


@pytest.mark.parametrize("arch", DENSE)
def test_init_tree_matches_reference_names_and_shapes(arch):
    tcfg = tget_reduced(arch)
    params = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    manifest = tpack.build_manifest(params)
    got = [(s.name, s.shape, s.dtype) for s in manifest.specs]
    assert got == _reference_specs(jget_reduced(arch))
    assert isinstance(params["segments"], list)
    assert all(isinstance(seg, tuple) for seg in params["segments"])


def test_fedlm_100m_manifest_equals_the_reference():
    params = ttf.init_params(torch.Generator().manual_seed(0), tfedlm(), "cpu")
    manifest = tpack.build_manifest(params)
    want = _reference_specs(jfedlm())
    assert [(s.name, s.shape, s.dtype) for s in manifest.specs] == want
    assert len(manifest.specs) == 11
    assert manifest.total_elements == 73_937_664
    offsets = np.cumsum([0] + [math.prod(shape) for _, shape, _ in want])[:-1]
    assert [s.offset for s in manifest.specs] == offsets.tolist()
    assert tpack.round_up(manifest.total_elements, 1024) == 73_937_920
    assert manifest.spec_by_name("['segments'][0][0]['attn']['wk']").shape == (8, 768, 256)


def test_dense_init_distribution():
    """Truncated at ±2σ; σ = 1/sqrt(fan_in), the truncated normal's spread
    0.8796σ; the embedding at σ = 0.02."""
    g = torch.Generator().manual_seed(0)
    w = tlayers._dense_init(g, (400, 1000), torch.float32)
    sigma = 1 / math.sqrt(400)
    assert w.abs().max() <= 2 * sigma + 1e-7
    assert abs(float(w.std()) / sigma - 0.8796) < 0.01
    assert abs(float(w.mean())) < 1e-3 * sigma * 10
    e = tlayers._dense_init(g, (512, 64), torch.float32, scale=0.02)
    assert e.abs().max() <= 0.04 + 1e-7 and abs(float(e.std()) / 0.02 - 0.8796) < 0.02


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_apply_norm_matches_reference(norm_type, dtype):
    jdt, tdt = _DTYPES[dtype]
    jcfg = dataclasses.replace(jget_reduced("qwen3-14b"), norm_type=norm_type)
    tcfg = dataclasses.replace(tget_reduced("qwen3-14b"), norm_type=norm_type)
    r = _rng()
    x = r.normal(size=(2, 5, 256)).astype(np.float32) * 3
    p = {"scale": r.normal(size=(256,)).astype(np.float32),
         "bias": r.normal(size=(256,)).astype(np.float32)}
    if norm_type == "rmsnorm":
        del p["bias"]
    want = jlayers.apply_norm(p, jnp.asarray(x, jdt), jcfg)
    got = tlayers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x).to(tdt), tcfg)
    assert got.dtype == tdt
    # f32 statistics and apply in both, one rounding to the input dtype.
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    qk = jlayers._rms_head_norm(jnp.asarray(p["scale"][:32]), jnp.asarray(x[..., :32], jdt))
    tqk = tlayers._rms_head_norm(torch.from_numpy(p["scale"][:32]),
                                 torch.from_numpy(x[..., :32]).to(tdt))
    np.testing.assert_allclose(tqk.float().numpy(), np.asarray(qk, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_and_sinusoidal_match_reference(theta):
    r = _rng(1)
    x = r.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = np.arange(3, 10)[None, :]
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlayers.rope_freqs(32, theta).numpy(),
                               np.asarray(jlayers.rope_freqs(32, theta)), rtol=1e-6)
    want = jlayers.sinusoidal_embedding(jnp.asarray(pos), 64)
    got = tlayers.sinusoidal_embedding(torch.from_numpy(pos), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["causal", "sliding", "full"])
@pytest.mark.parametrize("q_offset", [0, 5])
def test_attn_mask_matches_reference(mode, q_offset):
    want = jlayers._attn_mask(6, 13, q_offset, mode, 4)
    got = tlayers._attn_mask(6, 13, q_offset, mode, 4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["causal", "sliding", "full"])
def test_naive_and_chunked_attention_match_reference(mode):
    """Both paths against the reference's, and against each other: 20 keys
    in chunks of 8 (a padded last chunk), window 5."""
    r = _rng(2)
    B, S, H, hd = 2, 20, 4, 16
    q, k, v = (r.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3))
    scale = 1 / math.sqrt(hd)
    mask = np.array(jlayers._attn_mask(S, S, 0, mode, 5))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jn = jlayers._sdpa_naive(jq, jk, jv, jnp.asarray(mask), None, head_sharded=False,
                             scale=scale)
    jc = jlayers._sdpa_chunked(jq, jk, jv, None, head_sharded=False, scale=scale, mode=mode,
                               window=5, q_offset=0, chunk=8)
    tn = tlayers._sdpa_naive(tq, tk, tv, torch.from_numpy(mask), scale=scale)
    tc = tlayers._sdpa_chunked(tq, tk, tv, scale=scale, mode=mode, window=5, q_offset=0,
                               chunk=8)
    for got, want in ((tn, jn), (tc, jc), (tc, tn)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen2-72b"])
@pytest.mark.parametrize("chunked", [False, True])
def test_apply_attention_matches_reference(arch, chunked):
    """GQA with qk-norm, sliding windows (gemma) or qkv bias (qwen2); the
    chunked path chosen as the reference chooses it (``attn_chunk_min_len``)."""
    over = dict(dtype=jnp.float32, attn_k_chunk=8, attn_chunk_min_len=8 if chunked else 2048)
    jcfg = dataclasses.replace(jget_reduced(arch), **over)
    tcfg = dataclasses.replace(tget_reduced(arch), **{**over, "dtype": torch.float32})
    assert tlayers._use_chunked(tcfg, 19, 19) == chunked
    jp = jlayers.init_attention(jax.random.key(3), jcfg)
    jp = {k: v + 0.1 if k.startswith("b") else v for k, v in jp.items()}
    tp = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = _rng(3).normal(size=(2, 19, jcfg.d_model)).astype(np.float32)
    pos = np.arange(19)[None, :]
    for mode in ("causal", "sliding"):
        want, _ = jlayers.apply_attention(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                          mode=mode)
        got, _ = tlayers.apply_attention(tp, torch.from_numpy(x), tcfg,
                                         positions=torch.from_numpy(pos), mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gated", [True, False])
def test_apply_mlp_matches_reference(gated):
    """SiLU-gated, and the plain branch with GELU's tanh approximation."""
    jcfg = dataclasses.replace(jget_reduced("qwen3-14b"), mlp_gated=gated)
    tcfg = dataclasses.replace(tget_reduced("qwen3-14b"), mlp_gated=gated)
    jp = jlayers.init_mlp(jax.random.key(4), jcfg)
    jp = {k: v + 0.1 if k.startswith("b") else v for k, v in jp.items()}
    tp = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = _rng(4).normal(size=(2, 6, jcfg.d_model)).astype(np.float32)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), jcfg)
    got = tlayers.apply_mlp(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# forward, loss, gradients, steps
# ---------------------------------------------------------------------------


def _fedlm_small(cfg):
    """fedlm-100m's family (tied embeddings, GQA, padded vocab) at a test size."""
    return dataclasses.replace(cfg, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                               head_dim=32, d_ff=256, vocab_size=1000)


def _case(arch, dtype):
    """(reference cfg, port cfg, reference params, port params, numpy batch)."""
    jdt, tdt = _DTYPES[dtype]
    if arch == "fedlm-100m":
        jcfg, tcfg = _fedlm_small(jfedlm()), _fedlm_small(tfedlm())
    else:
        jcfg, tcfg = jget_reduced(arch), tget_reduced(arch)
    jcfg = dataclasses.replace(jcfg, dtype=jdt)
    tcfg = dataclasses.replace(tcfg, dtype=tdt)
    jp = jtf.init_params(jax.random.key(0), jcfg)
    tp = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    r = _rng(5)
    batch = {"tokens": r.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32),
             "labels": r.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)}
    if jcfg.frontend:
        batch["prefix_embeds"] = r.normal(
            size=(2, jcfg.num_prefix_tokens, jcfg.frontend_dim)).astype(np.float32)
    return jcfg, tcfg, jp, tp, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


_BARS = {"float32": dict(logits=1e-5, loss=1e-5, grad=1e-4),
         "bfloat16": dict(logits=0.1, loss=5e-4, grad=0.1)}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("arch", DENSE + ("fedlm-100m",))
def test_forward_loss_and_gradients_match_reference(arch, dtype):
    jcfg, tcfg, jp, tp, batch = _case(arch, dtype)
    bars = _BARS[dtype]
    tb = _torch_batch(batch)
    jlogits, _, _ = jax.jit(lambda p, b: jtf.forward(
        p, b["tokens"], jcfg, prefix_embeds=b.get("prefix_embeds")))(jp, batch)
    tlogits, caches, aux = ttf.forward(tp, tb["tokens"], tcfg,
                                       prefix_embeds=tb.get("prefix_embeds"))
    assert caches is None and float(aux) == 0.0
    assert tlogits.dtype == tcfg.dtype and tlogits.shape == (2, 24, tcfg.padded_vocab_size)
    V = tcfg.vocab_size
    np.testing.assert_allclose(tlogits[..., :V].float().numpy(),
                               np.asarray(jlogits[..., :V], np.float32),
                               rtol=bars["logits"], atol=bars["logits"])
    # The padded vocabulary is masked at -1e30 in the logits' dtype.
    assert (tlogits[..., V:].float() < -1e29).all()

    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jtf.lm_loss(p, b, jcfg)))(jp, batch)
    tgrads, tloss = torch.func.grad_and_value(lambda p: ttf.lm_loss(p, tb, tcfg))(tp)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=bars["loss"],
                               atol=bars["loss"] if dtype == "float32" else 0)
    jleaves, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    tleaves = flatten(tgrads)[0]
    assert len(jleaves) == len(tleaves)
    for (path, want), got in zip(jleaves, tleaves):
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(got.numpy() - want).max()) / scale
        assert err <= bars["grad"], (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("arch", ["qwen3-14b", "llava-next-34b"])
def test_train_and_prefill_steps_match_reference(arch):
    jcfg, tcfg, jp, tp, batch = _case(arch, "float32")
    tb = _torch_batch(batch)
    jstep = jsteps.make_train_step(jcfg, joptim.sgd(0.1))
    tstep = tsteps.make_train_step(tcfg, toptim.sgd(0.1))
    jnew, _, jloss = jax.jit(jstep)(jp, (), batch)
    tnew, _, tloss = tstep(tp, (), tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for got, want in zip(flatten(tnew)[0], jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    jtok = jax.jit(jsteps.make_prefill_step(jcfg))(jp, batch)
    ttok = tsteps.make_prefill_step(tcfg)(tp, tb)
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
