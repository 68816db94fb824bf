"""Serving launcher of the port: prefill a batch of requests, then decode tokens.

The port of ``repro/launch/serve.py``.  Like the reference, the command line
serves the reduced config of ``--arch``; ``--device`` (the card by default)
picks where it runs:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
        --batch 4 --prompt-len 32 --gen-len 16 [--device cpu]

:func:`serve` is the loop itself, for any config and params: prefill steps
the decoder over the prompt one token at a time (filling the cache), then
decode generates greedily from the last prompt token's prediction.

``--push-replicas N`` first publishes the served weights to N replica hosts
through the federation transport's serialize-once broadcast
(``Channel.broadcast``, as the controller's dispatch uses it) and prints the
one-serialization fan-out accounting.  ``--replica-upload raw|int8`` then
echoes the weights back per replica through the measured uplink
(``Channel.upload``; ``int8`` quantizes each echo with the hand-written
kernel and the server dequantizes one), so both wire directions are
accounted.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHITECTURES, get_reduced
from repro_torch.core import Channel, packing
from repro_torch.device import full_f32, resolve_device, wait_queued
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import kvcache, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.tree import flatten

__all__ = ["push_to_replicas", "serve", "main"]


def push_to_replicas(params, n_replicas: int, bandwidth_gbps: float = 10.0,
                     replica_upload: str | None = None) -> tuple[Channel, float, float | None]:
    """Publish model weights to ``n_replicas`` serving hosts, serialize-once.

    One ``Channel.broadcast`` serialization, N shared envelopes; one replica
    deserializes its copy (one transfer of the whole wire buffer onto the
    params' device) as a check.  With ``replica_upload`` (``"raw"`` or
    ``"int8"``) every replica then reports its resident weights back through
    ``Channel.upload`` (a health-check echo) and the server decodes one echo,
    so the accounting covers both wire directions.  Prints the reference's
    accounting lines and checks its counts: one serialization and
    ``n_replicas`` messages down, ``n_replicas`` upload messages up.

    Each copy is dropped as soon as the flow no longer needs it (the host
    wire after the decode, the replica's tree once packed into its row, the
    decoded echo once waited for), which bounds the card's peak at about three
    times the weights (the weights, the packed row and the decoded echo).
    Returns ``(channel, push_s, echo_s)``: the channel (its ``channel.*``
    counters), and the seconds each direction took including its one decode
    (``echo_s`` is ``None`` without an echo), read after waiting for the card.
    """
    device = flatten(params)[0][0].device
    ch = Channel(bandwidth_gbps=bandwidth_gbps, upload_codec=replica_upload or "raw",
                 device=device)
    t0 = time.perf_counter()
    broadcast = ch.broadcast(params=params)
    envelopes = [broadcast.to({"replica": i}) for i in range(n_replicas)]
    replica_params = ch.recv(envelopes[0])  # one replica decodes as a check
    wait_queued(device)
    push_s = time.perf_counter() - t0
    del broadcast, envelopes
    tm = ch.telemetry
    print(
        f"push: {n_replicas} replicas, "
        f"{tm.value('channel.bytes_moved') / 1e6:.1f}MB on wire, "
        f"{tm.value('channel.serializations')} serialization(s) "
        f"(vs {n_replicas} per-send), "
        f"{push_s:.3f}s incl. one decode, "
        f"virtual wire {tm.value('channel.virtual_wire_s', 0.0) * 1e3:.1f}ms"
    )
    if tm.value("channel.serializations") != 1 or tm.value("channel.messages") != n_replicas:
        raise RuntimeError(f"push: {tm.value('channel.serializations')} serializations and "
                           f"{tm.value('channel.messages')} messages for {n_replicas} replicas")
    echo_s = None
    if replica_upload:
        buf = packing.pack_numeric(replica_params)
        del replica_params
        wait_queued(device)
        t0 = time.perf_counter()
        for i in range(n_replicas):
            env = ch.upload(buf, metadata={"replica": i})
        del buf
        echo = ch.recv_upload(env)  # the server decodes one echo as a check
        wait_queued(device)
        echo_s = time.perf_counter() - t0
        del echo, env
        down = tm.value("channel.bytes_moved")
        up = tm.value("channel.upload_bytes")
        print(
            f"echo: {n_replicas} uploads ({replica_upload}), "
            f"{up / 1e6:.1f}MB on wire "
            f"({down / max(up, 1):.2f}x vs downlink), "
            f"{echo_s:.3f}s incl. one decode, "
            f"virtual wire {tm.value('channel.upload_virtual_wire_s', 0.0) * 1e3:.1f}ms"
        )
        if tm.value("channel.upload_messages") != n_replicas:
            raise RuntimeError(f"echo: {tm.value('channel.upload_messages')} upload messages "
                               f"for {n_replicas} replicas")
        # per-replica round-trip estimate: the bandwidth model the
        # federation's wire-cost-aware task sizing reads
        rt = ch.round_trip_s(down // n_replicas, up // n_replicas)
        print(f"modeled per-replica round-trip: {rt * 1e3:.1f}ms "
              f"(push down + {replica_upload} echo up)")
    return ch, push_s, echo_s


def serve(params, cfg: ModelConfig, prompts: torch.Tensor, gen_len: int, *,
          memory: torch.Tensor | None = None) -> tuple[torch.Tensor, float, float]:
    """Greedy generation for a batch of prompts on the params' device.

    ``prompts`` (B, prompt_len) of token ids, on the device the params are
    on; ``memory`` an encoder-decoder's encoder output.  A zeroed cache of
    ``prompt_len + gen_len`` positions in bf16 (``kvcache.init_cache``'s
    default, as the reference's launcher uses it); prefill steps the decoder
    over the prompt one token at a time, then ``gen_len`` steps each feed the
    previous step's token.  Returns ``(tokens (B, gen_len) int32, prefill_s,
    decode_s)``, each time read after waiting for the device.
    """
    B, prompt_len = prompts.shape
    if prompt_len < 1 or gen_len < 1:
        raise ValueError(f"serve needs a prompt and a generation, got {prompt_len} "
                         f"and {gen_len} tokens")
    max_len = prompt_len + gen_len
    device = prompts.device
    step = make_serve_step(cfg)
    caches = kvcache.init_cache(cfg, B, max_len, device=device)
    positions = torch.arange(max_len, device=device)  # 0-d views: no host copy a step

    wait_queued(device)
    t0 = time.perf_counter()
    for t in range(prompt_len):
        nxt, caches = step(params, caches, prompts[:, t:t + 1], positions[t], memory)
    wait_queued(device)
    prefill_s = time.perf_counter() - t0

    generated = []
    t0 = time.perf_counter()
    for t in range(prompt_len, max_len):
        nxt, caches = step(params, caches, nxt, positions[t], memory)
        generated.append(nxt)
    wait_queued(device)
    decode_s = time.perf_counter() - t0
    return torch.cat(generated, dim=1), prefill_s, decode_s


def main(argv: list[str] | None = None) -> torch.Tensor:
    """Serve the reduced config of ``--arch``; returns the generated tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b", choices=ARCHITECTURES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--push-replicas", type=int, default=0,
                    help="simulate serialize-once weight push to N replicas")
    ap.add_argument("--replica-upload", choices=("raw", "int8"), default=None,
                    help="also echo weights back per replica through the "
                         "measured uplink with this codec")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)
    full_f32()
    device = resolve_device(args.device)
    # Host generators, so one seed gives the same model and prompts on every device.
    params = transformer.init_params(torch.Generator().manual_seed(args.seed), cfg, device)
    if args.push_replicas:
        push_to_replicas(params, args.push_replicas, replica_upload=args.replica_upload)
    B = args.batch
    prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                            generator=torch.Generator().manual_seed(args.seed + 1)).to(device)
    memory = None
    if cfg.is_encoder_decoder:
        frames = torch.randn((B, cfg.encoder_seq_len, cfg.frontend_dim),
                             generator=torch.Generator().manual_seed(2)).to(device)
        with torch.no_grad():
            memory = transformer.encode(params, frames, cfg)

    out, prefill_s, decode_s = serve(params, cfg, prompts, args.gen_len, memory=memory)
    print(f"arch={cfg.name} batch={B}")
    print(f"prefill: {args.prompt_len} steps in {prefill_s:.2f}s")
    print(
        f"decode:  {args.gen_len} tokens in {decode_s:.2f}s "
        f"({B * args.gen_len / decode_s:.1f} tok/s batch-aggregate)"
    )
    print("sample token ids:", out[0, :12].tolist())
    if bool((out < 0).any()) or bool((out >= cfg.padded_vocab_size).any()):
        raise RuntimeError(f"a generated token lies outside [0, {cfg.padded_vocab_size})")
    return out


if __name__ == "__main__":
    main()
