"""Serving, against the reference: the serve step, the launcher's loop, the
replica push and its echo, and the command line.

Weights are the reference's, carried across with
``core/packing.tree_from_numpy``; prompts come from numpy with a seed.  The
bars: the greedy tokens exactly (f32 compute, where no two logits of a step
come near a tie); the push's ``channel.*`` counters exactly and its wire bytes
byte for byte (the int8 echo is quantized by both packages' kernels' plain
versions, which are bit-identical); the printed accounting lines equal once
their measured seconds are masked.
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.transport as jtransport
import repro_torch.core.transport as ttransport
from repro.configs import get_reduced as jget_reduced
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import kvcache as jkv
from repro.models import transformer as jtf
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.core import packing as tpack
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import kvcache as tkv

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _case(arch, jdt=jnp.float32, tdt=torch.float32):
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jdt)
    tcfg = dataclasses.replace(tget_reduced(arch), dtype=tdt)
    jp = jtf.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _prompts(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-v3-671b", "mamba2-780m"])
def test_serve_step_tokens_match_reference(arch):
    """``make_serve_step`` over a 6-token prompt and 8 generated tokens, each
    package feeding back its own tokens: every step's next token equal, int32
    of shape (B, 1)."""
    jcfg, tcfg, jp, tp = _case(arch)
    B, P, G = 2, 6, 8
    prompts = _prompts(jcfg, B, P)
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    tstep = tsteps.make_serve_step(tcfg)
    jc = jkv.init_cache(jcfg, B, P + G, dtype=jnp.float32)
    tc = tkv.init_cache(tcfg, B, P + G, dtype=torch.float32, device="cpu")
    jtok, ttok = [], []
    for t in range(P + G):
        jin = jnp.asarray(prompts[:, t:t + 1]) if t < P else jnxt
        tin = torch.from_numpy(prompts[:, t:t + 1]) if t < P else tnxt
        jnxt, jc = jstep(jp, jc, jin, jnp.asarray(t, jnp.int32))
        tnxt, tc = tstep(tp, tc, tin, torch.tensor(t))
        assert tnxt.dtype == torch.int32 and tuple(tnxt.shape) == (B, 1)
        jtok.append(np.asarray(jnxt))
        ttok.append(tnxt.numpy())
    np.testing.assert_array_equal(np.concatenate(ttok, 1), np.concatenate(jtok, 1))


def test_serve_step_takes_the_first_of_equal_maxima():
    """Tied logits: ``jnp.argmax`` takes the first, and so does the port."""
    _, tcfg, _, tp = _case("qwen3-14b")
    tp = dict(tp, lm_head=torch.zeros_like(tp["lm_head"]))  # every logit 0 but the pad's
    cache = tkv.init_cache(tcfg, 2, 4, device="cpu")
    nxt, _ = tsteps.make_serve_step(tcfg)(tp, cache, torch.tensor([[3], [5]]), 0)
    assert nxt.tolist() == [[0], [0]]


def test_serve_matches_the_references_launcher_loop():
    """``serve`` (prefill one token at a time, then greedy decode, a bf16
    cache as the launcher's) against the reference's ``main`` loop with its
    jitted serve step, for whisper (memory from the encoder) and gemma3."""
    for arch in ("gemma3-4b", "whisper-large-v3"):
        jcfg, tcfg, jp, tp = _case(arch)
        B, P, G = 2, 5, 6
        prompts = _prompts(jcfg, B, P, seed=4)
        jmem = tmem = None
        if jcfg.is_encoder_decoder:
            frames = np.random.default_rng(2).normal(
                size=(B, jcfg.encoder_seq_len, jcfg.frontend_dim)).astype(np.float32)
            jmem = jtf.encode(jp, jnp.asarray(frames), jcfg)
            with torch.no_grad():
                tmem = tserve.transformer.encode(tp, torch.from_numpy(frames), tcfg)
        step = jax.jit(jsteps.make_serve_step(jcfg))
        caches = jkv.init_cache(jcfg, B, P + G)
        for t in range(P):
            nxt, caches = step(jp, caches, jnp.asarray(prompts[:, t:t + 1]),
                               jnp.asarray(t, jnp.int32), jmem)
        want = []
        for t in range(P, P + G):
            nxt, caches = step(jp, caches, nxt, jnp.asarray(t, jnp.int32), jmem)
            want.append(np.asarray(nxt))
        got, prefill_s, decode_s = tserve.serve(tp, tcfg, torch.from_numpy(prompts), G,
                                                memory=tmem)
        assert got.dtype == torch.int32 and tuple(got.shape) == (B, G)
        np.testing.assert_array_equal(got.numpy(), np.concatenate(want, 1), err_msg=arch)
        assert prefill_s > 0 and decode_s > 0


def test_serve_refuses_an_empty_prompt_or_generation():
    _, tcfg, _, tp = _case("qwen3-14b")
    with pytest.raises(ValueError, match="prompt and a generation"):
        tserve.serve(tp, tcfg, torch.zeros((1, 0), dtype=torch.int64), 3)
    with pytest.raises(ValueError, match="prompt and a generation"):
        tserve.serve(tp, tcfg, torch.zeros((1, 2), dtype=torch.int64), 0)


_COUNTERS = ("channel.serializations", "channel.messages", "channel.bytes_moved",
             "channel.upload_bytes", "channel.upload_messages", "channel.upload_meta_bytes")


def _spy(monkeypatch, module, seen):
    """Record each package's channel (its first broadcast) and every upload
    payload."""
    broadcast, upload = module.Channel.broadcast, module.Channel.upload

    def spy_broadcast(self, *args, **kw):
        seen["channel"] = self
        return broadcast(self, *args, **kw)

    def spy_upload(self, *args, **kw):
        env = upload(self, *args, **kw)
        seen.setdefault("payloads", []).append(np.asarray(env.payload).copy())
        return env

    monkeypatch.setattr(module.Channel, "broadcast", spy_broadcast)
    monkeypatch.setattr(module.Channel, "upload", spy_upload)


def _masked(text):
    """The printed lines with their measured seconds masked."""
    return re.sub(r"\d+\.\d+s incl", "<s> incl", text).splitlines()


@pytest.mark.parametrize("upload", [None, "raw", "int8"])
def test_push_to_replicas_matches_reference(monkeypatch, capsys, upload):
    """Three replicas of reduced gemma3: one serialization, three messages
    down, three uploads up; every ``channel.*`` counter equal, each echo's
    wire bytes identical, the same printed accounting."""
    _, _, jp, tp = _case("gemma3-4b", jnp.bfloat16, torch.bfloat16)
    jseen, tseen = {}, {}
    _spy(monkeypatch, jtransport, jseen)
    _spy(monkeypatch, ttransport, tseen)
    jserve.push_to_replicas(jp, 3, replica_upload=upload)
    jout = capsys.readouterr().out
    ch, push_s, echo_s = tserve.push_to_replicas(tp, 3, replica_upload=upload)
    tout = capsys.readouterr().out
    assert ch is tseen["channel"] and ch.device.type == "cpu"
    for name in _COUNTERS:
        assert ch.telemetry.value(name) == jseen["channel"].telemetry.value(name), name
    assert ch.telemetry.value("channel.serializations") == 1
    assert ch.telemetry.value("channel.messages") == 3
    assert ch.telemetry.value("channel.upload_messages") == (3 if upload else 0)
    assert push_s > 0 and (echo_s is None) == (upload is None)
    assert len(tseen.get("payloads", [])) == len(jseen.get("payloads", [])) == (3 if upload else 0)
    for got, want in zip(tseen.get("payloads", []), jseen.get("payloads", [])):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert _masked(tout) == _masked(jout)


def test_serve_command_line_runs_on_the_host():
    """``python -m repro_torch.launch.serve --device cpu`` with an int8 echo
    to three replicas exits 0 and prints the launcher's lines."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "gemma3-4b", "--batch", "2", "--prompt-len", "4", "--gen-len", "3",
         "--push-replicas", "3", "--replica-upload", "int8"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("push: 3 replicas") and "1 serialization(s)" in lines[0]
    assert lines[1].startswith("echo: 3 uploads (int8)")
    assert "arch=gemma3-4b-smoke batch=2" in lines
    assert any(line.startswith("decode:  3 tokens in") for line in lines)
