"""Decoding with a cache, module by module, against the reference.

The KV cache (``models/kvcache.py``), the decode branch of every layer kind
(GQA causal, a sliding ring past its wrap, cross-attention, MLA's absorbed
form, Mamba2's conv window and recurrence) and ``transformer.decode_step``
over the seven families of the reference's ``test_decode_matches_prefill``.
Inputs come from numpy with a seed; the reference's weights are carried
across with ``core/packing.tree_from_numpy``; the reference's decode step
runs under ``jax.jit`` on the CPU.  The bars:

* cache trees: names, shapes, dtypes and bytes exactly;
* ``_ring_positions``: exactly (integers);
* layers and whole models in f32: rtol 1e-4 / atol 1e-5 for every step's
  output or logits and every final cache leaf (the frameworks' CPU BLAS sum
  in different orders, and the error grows with depth and steps);
* one bf16 model at the dense family's bf16 logits bar, 0.1
  (``tests/test_torch_models.py``);
* the port's decode against its own prefill at the reference's 2e-3
  (``test_decode_matches_prefill``): MLA's absorbed decode rounds otherwise
  than its expanded prefill.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models as tmodels
from repro.configs import ARCHITECTURES as J_ARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import config as jmcfg
from repro.models import kvcache as jkv
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.core import packing as tpack
from repro_torch.models import kvcache as tkv
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.tree import flatten, flatten_with_path

DECODE_ARCHS = ("gemma3-4b", "mamba2-780m", "zamba2-1.2b", "deepseek-v3-671b",
                "qwen3-14b", "whisper-large-v3", "qwen2-moe-a2.7b")
TOL = dict(rtol=1e-4, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _carry(tree):
    return tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _assert_trees_close(got, want, **tol):
    """Leaf by leaf, names included (the port's tree against the reference's)."""
    g_named, _ = flatten_with_path(got)
    w_leaves, _ = jax.tree_util.tree_flatten_with_path(want)
    assert [n for n, _ in g_named] == [jax.tree_util.keystr(p) for p, _ in w_leaves]
    for (name, g), (_, w) in zip(g_named, w_leaves):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), err_msg=name, **tol)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


def _cache_configs(arch, variant):
    if variant == "reduced":
        return jget_reduced(arch), tget_reduced(arch)
    return jget_config(arch), tget_config(arch)


@pytest.mark.parametrize("variant,batch,max_len", [("reduced", 2, 40), ("full", 4, 1056)])
@pytest.mark.parametrize("arch", J_ARCHS)
def test_cache_trees_match_reference(arch, variant, batch, max_len):
    """``abstract_cache``: the reference's tree leaf for leaf (names, shapes,
    dtypes), in bf16 and f32; ``cache_bytes`` equal; at the reduced size
    ``init_cache`` allocates that tree in zeros on the CPU."""
    jcfg, tcfg = _cache_configs(arch, variant)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = jax.tree_util.tree_flatten_with_path(
            jkv.abstract_cache(jcfg, batch, max_len, jdt),
            is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))[0]
        abstract = tkv.abstract_cache(tcfg, batch, max_len, tdt)
        got = flatten_with_path(abstract)[0]
        assert [(n, tuple(t.shape), tpack.dtype_name(t.dtype)) for n, t in got] == [
            (jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype)) for p, s in want]
        assert all(t.device.type == "meta" for _, t in got)
        assert tkv.cache_bytes(tcfg, batch, max_len, tdt) == jkv.cache_bytes(
            jcfg, batch, max_len, jdt)
        assert len(abstract) == len(jmcfg.plan_segments(jcfg))
        assert all(isinstance(unit, tuple) for unit in abstract)
    if variant == "reduced":
        cache = tkv.init_cache(tcfg, batch, max_len, device="cpu")
        leaves = flatten(cache)[0]
        assert [(tuple(t.shape), t.dtype) for t in leaves] == [
            (tuple(t.shape), t.dtype) for t in flatten(tkv.abstract_cache(tcfg, batch, max_len))[0]]
        assert all(t.device.type == "cpu" and not t.any() for t in leaves)


def test_gemma3_full_cache_is_a_ring_on_29_layers():
    """gemma3-4b at the serve shape (batch 4, 1056 positions): 29 sliding
    layers hold their 1024-slot window, the 5 global ones all 1056 positions."""
    cfg = tget_config("gemma3-4b")
    ks = [t for n, t in flatten_with_path(tkv.abstract_cache(cfg, 4, 1056))[0]
          if n.endswith("['k']")]
    lengths = [t.shape[0] * [t.shape[2]] for t in ks]
    lengths = sorted(L for ls in lengths for L in ls)
    assert lengths == [1024] * 29 + [1056] * 5
    assert tkv.cache_bytes(cfg, 4, 1056) == 2 * 2 * 4 * 4 * 256 * (29 * 1024 + 5 * 1056)


def test_init_cache_goes_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkv.init_cache(tget_reduced("qwen3-14b"), 1, 4)


def test_ring_positions_match_reference():
    """Every slot's stored position over a grid of positions and ring sizes,
    before, at and past each wrap."""
    for L in (1, 3, 5, 16):
        slots = np.arange(L)
        for pos in range(0, 3 * L + 2):
            want = np.asarray(jlayers._ring_positions(jnp.asarray(slots), jnp.asarray(pos), L))
            got = tlayers._ring_positions(torch.from_numpy(slots), torch.tensor(pos), L)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"pos={pos} L={L}")


# ---------------------------------------------------------------------------
# layer-level decode branches
# ---------------------------------------------------------------------------


def _pair(**fields):
    return (JModelConfig(**fields, dtype=jnp.float32),
            TModelConfig(**fields, dtype=torch.float32))


def _attn_pair(window=48):
    return _pair(name="t", arch_type="dense", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                 d_ff=128, vocab_size=100, sliding_window=window, qk_norm=True)


def _step_layer(jfn, tfn, jcache, tcache, xs, tol=TOL):
    """Feed ``xs[:, t]`` at position t through both packages' decode; each
    step's output and cache at ``tol``.  The port must write into the tensors
    it was given and return them."""
    ptrs = [t.data_ptr() for t in flatten(tcache)[0]]
    for t in range(xs.shape[1]):
        x = xs[:, t:t + 1]
        jy, jcache = jfn(jnp.asarray(x), jcache, jnp.asarray(t, jnp.int32))
        ty, out = tfn(torch.from_numpy(x), tcache, torch.tensor(t))
        assert out is tcache
        np.testing.assert_allclose(_np(ty), np.asarray(jy), err_msg=f"step {t}", **tol)
        _assert_trees_close(tcache, jcache, **tol)
    assert [t.data_ptr() for t in flatten(tcache)[0]] == ptrs
    return tcache


@pytest.mark.parametrize("mode,window,L,steps", [
    ("causal", 48, 12, 12),  # a linear cache, filled to its end
    ("sliding", 5, 5, 14),  # a ring of 5 slots: wraps at 5 and 10
    ("sliding", 48, 9, 9),  # a sliding layer whose window passes max_len: linear
])
def test_attention_decode_matches_reference(mode, window, L, steps):
    jcfg, tcfg = _attn_pair(window)
    jp = jlayers.init_attention(jax.random.key(3), jcfg)
    tp = _carry(jp)
    xs = _rng(3).normal(size=(2, steps, 64)).astype(np.float32)
    zeros = np.zeros((2, L, 2, 16), np.float32)
    jcache = {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)}
    tcache = {"k": torch.zeros((2, L, 2, 16)), "v": torch.zeros((2, L, 2, 16))}

    def jfn(x, c, pos):
        return jlayers.apply_attention(jp, x, jcfg, positions=pos[None, None], mode=mode,
                                       kv_cache=c, decode_pos=pos)

    def tfn(x, c, pos):
        return tlayers.apply_attention(tp, x, tcfg, positions=pos[None, None], mode=mode,
                                       kv_cache=c, decode_pos=pos)

    _step_layer(jax.jit(jfn), tfn, jcache, tcache, xs)


def test_sliding_ring_decode_matches_the_sliding_prefill():
    """Past the wrap, each decode output equals the sliding prefill's output
    at that position (the ring's ``age < L`` mask against the prefill's
    ``kj > qi - window``)."""
    _, tcfg = _attn_pair(5)
    tp = _carry(jlayers.init_attention(jax.random.key(4), _attn_pair(5)[0]))
    xs = torch.from_numpy(_rng(4).normal(size=(2, 17, 64)).astype(np.float32))
    prefill, _ = tlayers.apply_attention(tp, xs, tcfg, positions=torch.arange(17)[None, :],
                                         mode="sliding")
    cache = {"k": torch.zeros((2, 5, 2, 16)), "v": torch.zeros((2, 5, 2, 16))}
    for t in range(17):
        y, _ = tlayers.apply_attention(tp, xs[:, t:t + 1], tcfg,
                                       positions=torch.tensor([[t]]), mode="sliding",
                                       kv_cache=cache, decode_pos=t)
        np.testing.assert_allclose(y.numpy(), prefill[:, t:t + 1].numpy(), **TOL)


def test_cross_attention_decode_matches_reference():
    """Cross-attention with a cache: the memory's keys and values are
    recomputed, the cache is returned untouched."""
    jcfg, tcfg = _attn_pair()
    jcfg = dataclasses.replace(jcfg, pos_embedding="sinusoidal", qk_norm=False, qkv_bias=True)
    tcfg = dataclasses.replace(tcfg, pos_embedding="sinusoidal", qk_norm=False, qkv_bias=True)
    jp = jlayers.init_attention(jax.random.key(5), jcfg, cross=True)
    jp = {k: v + 0.1 if k.startswith("b") else v for k, v in jp.items()}
    tp = _carry(jp)
    r = _rng(5)
    mem = r.normal(size=(2, 7, 64)).astype(np.float32)
    cache = r.normal(size=(2, 6, 2, 16)).astype(np.float32)
    tcache = {"k": torch.from_numpy(cache.copy()), "v": torch.from_numpy(cache.copy())}
    for t in range(3):
        x = r.normal(size=(2, 1, 64)).astype(np.float32)
        jy, jc = jlayers.apply_attention(
            jp, jnp.asarray(x), jcfg, positions=jnp.asarray([[t]]), mode="full",
            kv_cache={"k": jnp.asarray(cache), "v": jnp.asarray(cache)},
            decode_pos=jnp.asarray(t), x_cross=jnp.asarray(mem))
        ty, tc = tlayers.apply_attention(tp, torch.from_numpy(x), tcfg,
                                         positions=torch.tensor([[t]]), mode="full",
                                         kv_cache=tcache, decode_pos=t,
                                         x_cross=torch.from_numpy(mem))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        assert tc is tcache
        np.testing.assert_array_equal(tc["k"].numpy(), cache)
        np.testing.assert_array_equal(tc["v"].numpy(), cache)


def test_mla_absorbed_decode_matches_reference():
    """The absorbed decode (``q_nope W_UK`` against the latent, the read-out
    in latent space expanded by ``W_UV``) step by step, cache included."""
    fields = dict(name="t", arch_type="dense", n_layers=1, d_model=64, n_heads=4, n_kv_heads=4,
                  d_ff=128, vocab_size=100, attn_impl="mla", q_lora_rank=24, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    jcfg, tcfg = _pair(**fields)
    jp = jlayers.init_mla(jax.random.key(2), jcfg)
    tp = _carry(jp)
    xs = _rng(6).normal(size=(2, 10, 64)).astype(np.float32)
    jcache = {"ckv": jnp.zeros((2, 10, 16)), "kpe": jnp.zeros((2, 10, 8))}
    tcache = {"ckv": torch.zeros((2, 10, 16)), "kpe": torch.zeros((2, 10, 8))}

    def jfn(x, c, pos):
        return jlayers.apply_mla(jp, x, jcfg, positions=pos[None, None], mode="causal",
                                 kv_cache=c, decode_pos=pos)

    def tfn(x, c, pos):
        return tlayers.apply_mla(tp, x, tcfg, positions=pos[None, None], mode="causal",
                                 kv_cache=c, decode_pos=pos)

    _step_layer(jax.jit(jfn), tfn, jcache, tcache, xs)
    # ... and, at the reference's own bar, the port's expanded prefill.
    prefill, _ = tlayers.apply_mla(tp, torch.from_numpy(xs), tcfg,
                                   positions=torch.arange(10)[None, :], mode="causal")
    tcache = {"ckv": torch.zeros((2, 10, 16)), "kpe": torch.zeros((2, 10, 8))}
    for t in range(10):
        y, _ = tlayers.apply_mla(tp, torch.from_numpy(xs[:, t:t + 1]), tcfg,
                                 positions=torch.tensor([[t]]), mode="causal",
                                 kv_cache=tcache, decode_pos=t)
        np.testing.assert_allclose(y.numpy(), prefill[:, t:t + 1].numpy(), atol=2e-3)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_reference(cache_dtype):
    """The conv window over the cached W-1 inputs and the one-step
    recurrence; ``conv`` comes back in the cache's dtype, ``ssm`` in f32.  A
    bf16 ``conv`` rounds the f32 in-projection: where the two frameworks'
    products differ in the last f32 bit beside a bf16 rounding boundary, the
    cached value differs by one bf16 ulp (2^-7 relative), and the next
    outputs by up to about 2e-5; so that case is held at rtol 2^-7 / atol
    1e-4."""
    jdt, tdt = (jnp.float32, torch.float32) if cache_dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    jcfg, tcfg = _pair(name="t", arch_type="ssm", n_layers=1, d_model=64, n_heads=4,
                       n_kv_heads=4, d_ff=0, vocab_size=100, ssm_state=16, ssm_head_dim=16,
                       ssm_chunk=8)
    jp = jlayers.init_mamba(jax.random.key(0), jcfg)
    jp["conv_b"] = jp["conv_b"] + 0.05
    tp = _carry(jp)
    xs = _rng(7).normal(size=(2, 9, 64)).astype(np.float32)
    ch = tcfg.d_inner + 2 * tcfg.ssm_state
    jcache = {"conv": jnp.zeros((2, 3, ch), jdt),
              "ssm": jnp.zeros((2, tcfg.ssm_heads, 16, 16), jnp.float32)}
    tcache = {"conv": torch.zeros((2, 3, ch), dtype=tdt),
              "ssm": torch.zeros((2, tcfg.ssm_heads, 16, 16))}

    def jfn(x, c, pos):
        return jlayers.apply_mamba(jp, x, jcfg, cache=c, decode_pos=pos)

    def tfn(x, c, pos):
        return tlayers.apply_mamba(tp, x, tcfg, cache=c)

    tol = TOL if cache_dtype == "float32" else dict(rtol=2 ** -7, atol=1e-4)
    _step_layer(jax.jit(jfn), tfn, jcache, tcache, xs, tol)
    assert tcache["conv"].dtype == tdt and tcache["ssm"].dtype == torch.float32


def test_mamba_decode_is_the_chunked_scan_one_step_at_a_time():
    """The reference's ``test_ssd_chunked_matches_sequential``: the mixer's
    prefill (chunked SSD over 19 positions in chunks of 8) against its decode
    over the same positions, at that test's atol 1e-3."""
    _, tcfg = _pair(name="t", arch_type="ssm", n_layers=1, d_model=64, n_heads=4,
                    n_kv_heads=4, d_ff=0, vocab_size=100, ssm_state=16, ssm_head_dim=16,
                    ssm_chunk=8)
    tp = tlayers.init_mamba(torch.Generator().manual_seed(1), tcfg)
    xs = torch.from_numpy(_rng(8).normal(size=(2, 19, 64)).astype(np.float32))
    prefill, _ = tlayers.apply_mamba(tp, xs, tcfg)
    cache = {"conv": torch.zeros((2, 3, tcfg.d_inner + 32)),
             "ssm": torch.zeros((2, tcfg.ssm_heads, 16, 16))}
    steps = [tlayers.apply_mamba(tp, xs[:, t:t + 1], tcfg, cache=cache)[0] for t in range(19)]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), prefill.numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _model_case(arch, jdt=jnp.float32, tdt=torch.float32):
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jdt)
    tcfg = dataclasses.replace(tget_reduced(arch), dtype=tdt)
    jp = jtf.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, _carry(jp)


def _memory(jcfg, tcfg, jp, tp, B):
    if not jcfg.is_encoder_decoder:
        return None, None
    frames = _rng(2).normal(size=(B, jcfg.encoder_seq_len, jcfg.frontend_dim)).astype(np.float32)
    with torch.no_grad():
        tmem = ttf.encode(tp, torch.from_numpy(frames), tcfg)
    return jtf.encode(jp, jnp.asarray(frames), jcfg), tmem


def _decode_both(arch, S, max_len, jdt=jnp.float32, tdt=torch.float32):
    """Step both packages' ``decode_step`` over S tokens; returns the logits
    of each step (reference, port), both final caches and the port's
    params, tokens and memory."""
    jcfg, tcfg, jp, tp = _model_case(arch, jdt, tdt)
    B = 2
    tokens = _rng(1).integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jmem, tmem = _memory(jcfg, tcfg, jp, tp, B)
    step = jax.jit(lambda p, tok, c, pos, m: jtf.decode_step(p, tok, c, pos, jcfg, memory=m))
    jcache = jkv.init_cache(jcfg, B, max_len, dtype=jdt)
    tcache = tkv.init_cache(tcfg, B, max_len, dtype=tdt, device="cpu")
    jl, tl = [], []
    for t in range(S):
        lg, jcache = step(jp, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.asarray(t, jnp.int32),
                          jmem)
        jl.append(np.asarray(lg, np.float32))
        lg, out = ttf.decode_step(tp, torch.from_numpy(tokens[:, t:t + 1]), tcache, t, tcfg,
                                  memory=tmem)
        assert out is tcache
        tl.append(_np(lg))
    return jl, tl, jcache, tcache, (tcfg, tp, tokens, tmem)


@pytest.mark.parametrize("arch,S,max_len", [(a, 12, 16) for a in DECODE_ARCHS]
                         + [("gemma3-4b", 40, 40)])
def test_decode_step_matches_reference(arch, S, max_len):
    """Every step's logits and the final caches leaf by leaf, f32.  The
    40-position gemma3 case runs its 16-slot sliding rings through two wraps
    (at 16 and 32)."""
    jl, tl, jcache, tcache, (tcfg, *_) = _decode_both(arch, S, max_len)
    for t, (j, g) in enumerate(zip(jl, tl)):
        V = tcfg.vocab_size
        np.testing.assert_allclose(g[..., :V], j[..., :V], err_msg=f"{arch} step {t}", **TOL)
    _assert_trees_close(tcache, jcache, **TOL)
    if S == 40:
        ring = [t for n, t in flatten_with_path(tcache)[0] if n.endswith("['k']")]
        assert min(t.shape[2] for t in ring) == tcfg.sliding_window == 16 < S // 2


def test_decode_step_matches_reference_in_bf16():
    """gemma3-4b reduced in its bf16 compute dtype with a bf16 cache: the
    logits at the dense family's bf16 bar (0.1)."""
    jl, tl, _, tcache, (tcfg, *_) = _decode_both("gemma3-4b", 12, 16, jnp.bfloat16,
                                                 torch.bfloat16)
    assert flatten(tcache)[0][0].dtype == torch.bfloat16
    V = tcfg.vocab_size
    np.testing.assert_allclose(np.stack(tl)[..., :V], np.stack(jl)[..., :V], atol=0.1)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_own_prefill(arch):
    """The reference's ``test_decode_matches_prefill`` on the port: the 12
    decode steps' logits against one prefill ``forward`` at 2e-3; and every
    cache leaf is written in place (its storage never moves)."""
    jcfg, tcfg, jp, tp = _model_case(arch)
    B, S = 2, 12
    tokens = torch.from_numpy(_rng(1).integers(0, tcfg.vocab_size, size=(B, S)))
    _, tmem = _memory(jcfg, tcfg, jp, tp, B)
    with torch.no_grad():
        want = ttf.forward(tp, tokens, tcfg, memory=tmem)[0]
    cache = tkv.init_cache(tcfg, B, 16, dtype=torch.float32, device="cpu")
    ptrs = [t.data_ptr() for t in flatten(cache)[0]]
    got = [ttf.decode_step(tp, tokens[:, t:t + 1], cache, torch.tensor(t), tcfg,
                           memory=tmem)[0] for t in range(S)]
    assert [t.data_ptr() for t in flatten(cache)[0]] == ptrs
    assert any(t.abs().sum() > 0 for t in flatten(cache)[0])
    assert float((torch.cat(got, 1) - want).abs().max()) < 2e-3


def test_decode_step_takes_one_token_with_a_cache():
    tcfg = dataclasses.replace(tget_reduced("qwen3-14b"), dtype=torch.float32)
    tp = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    cache = tkv.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="one token"):
        ttf.forward(tp, torch.zeros((1, 2), dtype=torch.int64), tcfg, caches=cache,
                    decode_pos=0)
    with pytest.raises(ValueError, match="one token"):
        ttf.forward(tp, torch.zeros((1, 1), dtype=torch.int64), tcfg, caches=cache)


def test_models_export_kvcache():
    assert tmodels.kvcache is tkv
    assert tkv.__all__ == jkv.__all__ == ["init_cache", "abstract_cache", "cache_bytes"]
    assert "decode_step" in ttf.__all__


def test_decode_step_builds_one_mask_per_cache_length(monkeypatch):
    """A decode step builds each attention mask once per cache length and
    ring, shared by every layer: reduced gemma3 over 40 positions has 16-slot
    sliding rings and a 40-slot global cache, so two masks a step.  Its
    logits are bit-identical to building the mask in every layer."""
    tcfg = dataclasses.replace(tget_reduced("gemma3-4b"), dtype=torch.float32)
    tp = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    tokens = torch.from_numpy(_rng(1).integers(0, tcfg.vocab_size, size=(2, 20)))
    built = []
    fresh = tlayers._decode_mask

    def counted(L, pos, ring):
        built.append((L, ring))
        return fresh(L, pos, ring)

    def run():
        cache = tkv.init_cache(tcfg, 2, 40, dtype=torch.float32, device="cpu")
        return torch.cat([ttf.decode_step(tp, tokens[:, t:t + 1], cache, t, tcfg)[0]
                          for t in range(tokens.shape[1])], 1)

    monkeypatch.setattr(tlayers, "_decode_mask", counted)
    shared = run()
    assert sorted(set(built)) == [(16, True), (40, False)]
    assert len(built) == 2 * tokens.shape[1]
    monkeypatch.setattr(tlayers, "_step_mask", lambda masks, L, pos, ring: fresh(L, pos, ring))
    assert torch.equal(run(), shared)


def test_rope_table_is_built_once_and_equals_a_fresh_one():
    """``rope_freqs`` returns one table per (head dim, theta, device), the
    same values as computing it afresh from a 0-d theta tensor."""
    first = tlayers.rope_freqs(32, 10_000.0, torch.device("cpu"))
    assert tlayers.rope_freqs(32, 10_000.0, torch.device("cpu")) is first
    exps = torch.arange(0, 32, 2, dtype=torch.float32) / 32
    assert torch.equal(first, 1.0 / torch.pow(torch.tensor(10_000.0), exps))
    assert not torch.equal(tlayers.rope_freqs(32, 1_000_000.0, torch.device("cpu")), first)
