"""Serving example on the port: batched decode across three architecture
families — sliding-window dense (gemma3), attention-free SSM (mamba2), and
MLA MoE (deepseek) — through the same ``make_serve_step`` the dry-run counts.

The PyTorch twin of ``examples/serve_multiarch.py``, at the reference's
reduced configs, on the card.  The step runs eagerly; the decode cache is
written in place, so the warm-up step is followed by a fresh cache.

    PYTHONPATH=src python examples/torch_serve_multiarch.py                # the card
    PYTHONPATH=src python examples/torch_serve_multiarch.py --device cpu   # the host
"""

import argparse
import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.device import full_f32, resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import kvcache, transformer

ARCHS = ("gemma3-4b", "mamba2-780m", "deepseek-v3-671b")


def _sync(device: torch.device) -> None:
    """Wait for the card (``jax.block_until_ready``'s place); no-op on the host."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, batch=4, gen=24, device=None, cfg=None, params=None):
    """Greedy-decode ``gen`` tokens at ``batch`` from token 1; returns the
    ``(batch, gen)`` int32 tokens and the tokens/s.  ``cfg`` and ``params``
    replace the reduced config and its seeded init (e.g. carried from the
    reference)."""
    device = resolve_device(device)
    cfg = get_reduced(arch) if cfg is None else cfg
    if params is None:
        params = transformer.init_params(torch.Generator().manual_seed(0), cfg, device)
    step = make_serve_step(cfg)
    caches = kvcache.init_cache(cfg, batch, 64, device=device)
    tok = torch.full((batch, 1), 1, dtype=torch.int32, device=device)
    # warmup
    _, _ = step(params, caches, tok, torch.tensor(0, device=device), None)

    caches = kvcache.init_cache(cfg, batch, 64, device=device)
    # Made before the timed loop: a host-to-card copy inside it waits for the stream.
    positions = [torch.tensor(t, device=device) for t in range(gen)]
    out = []
    _sync(device)  # the warm-up's work stays out of the timed loop
    t0 = time.time()
    for t in range(gen):
        tok, caches = step(params, caches, tok, positions[t], None)
        out.append(tok)
    _sync(device)
    dt = time.time() - t0
    toks = torch.cat(out, dim=1)
    assert bool(torch.all((toks >= 0) & (toks < cfg.padded_vocab_size)))
    print(f"{arch:16s} {batch * gen / dt:8.1f} tok/s (batch={batch})  "
          f"sample: {toks[0, :8].tolist()}")
    return toks, batch * gen / dt


def main(argv=None):
    """Serve every family; returns ``{arch: (tokens, tokens_per_s)}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    full_f32()
    served = {arch: serve(arch, device=device) for arch in ARCHS}
    print("multi-family serving ✓")
    return served


if __name__ == "__main__":
    main()
