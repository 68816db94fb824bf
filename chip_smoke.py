"""Quickest proof that the PyTorch/CUDA port starts and is right on the card.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only; imports nothing of JAX and
nothing of the JAX package.  Phases, each printing its own lines:

1. env     — torch/CUDA versions and the card's name and power limit;
2. build   — nvcc builds ``kernels/csrc/fedavg.cu`` for sm_90a;
3. kernels — every hand-written kernel against its plain PyTorch version on
             the card (f32 atol=rtol=1e-5, bf16 atol=rtol=3e-2), NaN dead rows,
             all-zero weights, the empty mask; timings at the main path's shape;
4. check   — a small federation on the card agrees with the same federation
             on the host (global buffer, rtol 1e-4 / atol 1e-5: the two
             devices sum in different orders across local steps);
5. main    — ``launch/train.main`` at full width (housing-mlp-10m, 32
             learners, 3 sync rounds, f32 arena, raw codec), then the stack
             store's leg through ``Driver``/``FederationEnv`` with a lineage
             of two models per learner, which makes the Driver pick the
             stack store; each leg's launch counts are zeroed just before it
             and read just after.

Any failure exits non-zero before the result line.  Without CUDA, or without
the repository's ``src/`` beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
P_MAIN = 10_174_464  # housing-mlp-10m row, padded to the arena's 1024 alignment
P_STACK = 10_174_081  # housing-mlp-10m params: the stack leg's unpadded rows
N_MAIN = 32
ROUNDS = 3
LOCAL_STEPS = 4
BATCH = 100
LR = 0.05


def main() -> None:
    """Run every phase; any failure raises before the result line."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this check needs the card")
    src = pathlib.Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: the port's package is missing under {src}")
    sys.path.insert(0, str(src))

    from repro_torch.device import full_f32
    from repro_torch.kernels import _build
    from repro_torch.kernels import fedavg as kfed

    full_f32()
    dev = torch.device("cuda")

    # -- 1. env ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)  # name, power limit — as nvidia-smi gives them
    print(json.dumps({"phase": "env", "torch": torch.__version__,
                      "cuda": torch.version.cuda, "card": card}), flush=True)

    # -- 2. build -------------------------------------------------------------
    built = _build.load_library()
    print(json.dumps({"phase": "build", "library": str(built.path),
                      "nvcc_s": built.seconds,
                      "flags": " ".join(_build.NVCC_FLAGS)}), flush=True)
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    # -- 3. kernels -----------------------------------------------------------
    t_phase = time.perf_counter()
    errs = check_kernels(kfed, dev)
    timing = time_kernels(kfed, dev, errs)
    print(json.dumps({"phase": "kernels", "seconds": time.perf_counter() - t_phase}),
          flush=True)

    # -- 4. check: the card agrees with the host on a small federation -------
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    small = ["--arch", "housing-mlp", "--size", "100k", "--learners", "4",
             "--rounds", "2", "--local-steps", "2", "--batch-size", "100",
             "--lr", "0.01", "--seed", "0"]
    d_gpu, _ = train.main(small + ["--device", "cuda"])
    d_cpu, _ = train.main(small + ["--device", "cpu"])
    g = d_gpu.controller.global_buffer.cpu()
    h = d_cpu.controller.global_buffer
    check_err = float((g - h).abs().max())
    torch.testing.assert_close(g, h, rtol=1e-4, atol=1e-5)
    print(json.dumps({"phase": "check", "max_abs_err_vs_host": check_err,
                      "seconds": time.perf_counter() - t_phase}), flush=True)
    del d_gpu, d_cpu

    # -- 5. main path ---------------------------------------------------------
    full = ["--arch", "housing-mlp", "--size", "10m", "--learners", str(N_MAIN),
            "--rounds", str(ROUNDS), "--local-steps", str(LOCAL_STEPS),
            "--batch-size", str(BATCH), "--lr", str(LR), "--seed", "0",
            "--device", "cuda"]
    launches = {}
    for leg in ("arena", "stack"):
        kfed.masked_fedavg_cuda.launches = 0
        kfed.fedavg_cuda.launches = 0
        t_phase = time.perf_counter()
        driver, history = train.main(full) if leg == "arena" else run_stack_leg(train, dev)
        counts = {"masked_fedavg": kfed.masked_fedavg_cuda.launches,
                  "fedavg": kfed.fedavg_cuda.launches}
        c = driver.controller
        for h_ in history:
            print(json.dumps({"phase": f"main.{leg}", "round": h_.round_id,
                              "aggregation_s": h_.aggregation_s,
                              "federation_round_s": h_.federation_round_s,
                              "train_round_s": h_.train_round_s,
                              "eval_loss": h_.metrics["eval_loss"]}), flush=True)
            assert math.isfinite(h_.metrics["eval_loss"]), h_.metrics
        assert len(history) == ROUNDS, len(history)
        up = c.channel.stats.upload_bytes
        if leg == "arena":
            assert c.arena.buffer.device.type == "cuda", c.arena.buffer.device
            assert tuple(c.arena.buffer.shape) == (N_MAIN, P_MAIN), c.arena.buffer.shape
            assert c.arena.buffer.dtype == torch.float32
            assert counts == {"masked_fedavg": ROUNDS, "fedavg": 0}, counts
            assert up == N_MAIN * ROUNDS * 4 * P_MAIN, up
        else:
            assert c.arena is None and c.store_mode == "stack"
            assert counts == {"masked_fedavg": 0, "fedavg": ROUNDS}, counts
            assert up == N_MAIN * ROUNDS * 4 * P_STACK, up
        assert torch.isfinite(c.global_buffer).all()
        launches.update({k: v for k, v in counts.items() if v})
        # Where a round's time goes, from the run's own telemetry: summed
        # host seconds of each wire half (across learner threads, so they
        # overlap) and the learners' EWMA seconds per local step.
        tel = c.telemetry
        steps = [p["seconds_per_step"] for p in c._learner_profiles.values()]
        print(json.dumps({"phase": f"main.{leg}", "breakdown": {
            "broadcast_serialize_s": tel.value("channel.serialize_s"),
            "learner_recv_s": tel.value("channel.deserialize_s"),
            "learner_upload_encode_s": tel.value("channel.upload_serialize_s"),
            "controller_upload_decode_s": tel.value("channel.upload_deserialize_s"),
            "seconds_per_step_mean": statistics.fmean(steps),
            "aggregate_s_mean": tel.value("engine.aggregate_s"),
            "round_s_mean": tel.value("engine.round_s")}}), flush=True)
        print(json.dumps({"phase": f"main.{leg}", "launches": counts,
                          "upload_bytes": up,
                          "upload_meta_bytes": c.channel.stats.upload_meta_bytes,
                          "global_buffer": list(c.global_buffer.shape),
                          "seconds": time.perf_counter() - t_phase}), flush=True)
        del driver, history, c
        torch.cuda.empty_cache()

    rows = []
    for name, replaces in (("masked_fedavg", "src/repro/kernels/fedavg.py:181"),
                           ("fedavg", "src/repro/kernels/fedavg.py:126")):
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fedavg.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], **timing[name],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def run_stack_leg(train, dev):
    """The stack store's leg as users reach it: ``lineage_length=2`` makes the
    Driver pick the stack store, which re-stacks the rows every round and
    reduces them with the unmasked kernel.  Same model, data and seed as the
    arena leg's ``launch/train.main``."""
    from repro_torch import optim
    from repro_torch.core import Driver, FederationEnv, TerminationCriteria
    from repro_torch.models import mlp as mlp_model

    cfg, learners = train.build_housing_learners("10m", N_MAIN, seed=0,
                                                 optimizer=optim.sgd(LR), device=dev)
    initial = mlp_model.init_params(torch.Generator().manual_seed(0), cfg, dev)
    env = FederationEnv(protocol="sync", local_steps=LOCAL_STEPS, batch_size=BATCH,
                        learning_rate=LR, lineage_length=2,
                        termination=TerminationCriteria(max_rounds=ROUNDS), device=dev)
    driver = Driver(env)
    driver.initialize(initial, learners)
    return driver, driver.run()


def _close(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    return float((got - want).abs().max())


def check_kernels(kfed, dev) -> dict:
    """Both kernels against their plain versions at every listed shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"masked_fedavg": 0.0, "fedavg": 0.0}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        for n in (1, 7, 32, 64):
            for p in (1024, 50_001, P_STACK, P_MAIN):
                arena = (torch.randn((n, p), generator=gen, device=dev) * 3).to(dtype)
                w = torch.rand((n,), generator=gen, device=dev) + 0.05
                e_plain = _close(kfed.fedavg_cuda(arena, w), kfed.fedavg_torch(arena, w), tol)
                # Every third row dead (none when n == 1), filled with NaN.
                m = torch.ones((n,), device=dev)
                m[1::3] = 0.0
                arena[m == 0] = float("nan")
                e_mask = _close(kfed.masked_fedavg_cuda(arena, w, m),
                                kfed.masked_fedavg_torch(arena, w, m), tol)
                torch.cuda.synchronize()
                print(json.dumps({"phase": "kernels", "dtype": str(dtype), "n": n, "p": p,
                                  "fedavg_err": e_plain, "masked_err": e_mask, "tol": tol}),
                      flush=True)
                if dtype == torch.float32:
                    worst["fedavg"] = max(worst["fedavg"], e_plain)
                    worst["masked_fedavg"] = max(worst["masked_fedavg"], e_mask)
                del arena
        # Degenerate weights and masks at a ragged width.
        n, p = 7, 50_001
        arena = (torch.randn((n, p), generator=gen, device=dev) * 3).to(dtype)
        zero_w = torch.zeros((n,), device=dev)
        m = torch.ones((n,), device=dev)
        m[::2] = 0.0
        got = kfed.fedavg_cuda(arena, zero_w)  # uniform over every row
        _close(got, arena.float().mean(0), tol)
        got = kfed.masked_fedavg_cuda(arena, zero_w, m)  # uniform over valid rows
        _close(got, arena.float()[m > 0].mean(0), tol)
        got = kfed.masked_fedavg_cuda(arena, torch.rand((n,), device=dev),
                                      torch.zeros((n,), device=dev))
        assert torch.count_nonzero(got) == 0, "the empty mask must give zeros"
        print(json.dumps({"phase": "kernels", "dtype": str(dtype),
                          "zero_weights_uniform": True, "empty_mask_zeros": True}),
              flush=True)
    return worst


def _time_ms(fn, samples: int = 20, inner: int = 10) -> float:
    """Median over ``samples`` of CUDA-event time per call, ``inner`` calls
    back to back per sample (so host-side launch work overlaps the card)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def _bound(n: int, p: int, itemsize: int) -> tuple[float, str]:
    """Least time on the card: bytes (each input read once, the output written
    once) over HBM rate, or f32 FMAs over the f32 peak, whichever is larger."""
    t_bytes = (n * p * itemsize + 4 * p + 8 * n) / HBM_BYTES_PER_S
    t_ops = 2 * n * p / F32_FLOPS
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def time_kernels(kfed, dev, errs: dict) -> dict:
    """Kernel, plain and library times at the shapes the main path gives each
    kernel: the arena's (32, 10,174,464) f32 and the stack's (32, 10,174,081).
    Each kernel is first held against its plain version on the very inputs it
    is timed on; the error joins the kernel's worst in ``errs``."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for name, p in (("masked_fedavg", P_MAIN), ("fedavg", P_STACK)):
        rows = torch.randn((N_MAIN, p), generator=gen, device=dev)
        w = torch.rand((N_MAIN,), generator=gen, device=dev) + 0.05
        m = torch.ones((N_MAIN,), device=dev)
        w_hat = kfed.masked_normalize(w, m)
        if name == "masked_fedavg":
            kern = lambda: kfed.masked_fedavg_cuda(rows, w, m)  # noqa: E731
            plain = lambda: kfed.masked_fedavg_torch(rows, w, m)  # noqa: E731
        else:
            kern = lambda: kfed.fedavg_cuda(rows, w)  # noqa: E731
            plain = lambda: kfed.fedavg_torch(rows, w)  # noqa: E731
        library = lambda: torch.mv(rows.T, w_hat)  # noqa: E731
        err = _close(kern(), plain(), 1e-5)
        errs[name] = max(errs[name], err)
        # Interleaved (plain, kernel, kernel, plain) so drift hits both alike.
        t_plain_a = _time_ms(plain)
        t_kern_a = _time_ms(kern)
        t_kern_b = _time_ms(kern)
        t_plain_b = _time_ms(plain)
        t_lib = _time_ms(library)
        bound_ms, bound_by = _bound(N_MAIN, p, 4)
        out[name] = {"ms": min(t_kern_a, t_kern_b), "plain_ms": min(t_plain_a, t_plain_b),
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t_lib}
        print(json.dumps({"phase": "kernels", "timed": name, "n": N_MAIN, "p": p,
                          "max_abs_err": err,
                          "kernel_ms": [t_kern_a, t_kern_b],
                          "plain_ms": [t_plain_a, t_plain_b], "library_ms": t_lib,
                          "bound_ms": bound_ms, "launches_per_round": 1}), flush=True)
        del rows
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
