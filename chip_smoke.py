"""Quickest proof that the PyTorch/CUDA port starts and is right on the card.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only; imports nothing of JAX and
nothing of the JAX package.  Phases, each printing its own lines:

1. env     — torch/CUDA versions and the card's name and power limit;
2. build   — nvcc builds ``kernels/csrc/*.cu`` for sm_90a, one process per
             source, all at once;
3. kernels — every hand-written kernel against its plain PyTorch version on
             the card: FedAvg (f32 atol=rtol=1e-5, bf16 3e-2; NaN dead rows,
             all-zero weights, the empty mask, N = 1,100 and 2,500, a view
             ``arena[:, 1:]`` whose rows are not 16-byte aligned, P of 1, 3
             and 5, one live row of 32; two launches bit-identical; as
             diagnostics, the masked kernel timed with 16 of 32 rows dead and
             the device kernels ``torch.profiler`` sees per wrapper call);
             quantize and dequantize bit-identical (groups 256 and 512, with
             NaN, ±inf, all-zero and subnormal groups; ``ops.quantize`` on
             unpadded rows, a last group of 129 and tails at 1 and 7 mod 8,
             in one launch that writes the wire's layout; the encoder's wire
             bytes); the fused dequant-into-aggregate (atol=rtol=2e-5; NaN
             and 1e30 dead-row scales, zero weights, the empty mask); the
             masked trimmed mean (atol 1e-5, plus rtol 1e-5 at full width;
             N from 2 to 1000 across the sorting network's template sizes
             and the switch to the rank-select past 64, several ``trim_k``
             each, NaN and 1e30 dead rows, duplicated and negated rows,
             all-equal and ±0 columns, f32 and bf16, full width at N = 32
             and 64, a degenerate cohort, the empty mask, the ``ValueError``
             of an impossible trim); timings at the main path's shapes (the
             quantize row as the encoder calls it, ``ops.quantize`` on the
             unpadded row, on inputs in rotation), with the device kernels
             and device time the profiler sees per call and the host time
             per call;
4. check   — small federations on the card agree with the same federations
             on the host: f32 (global buffer, rtol 1e-4 / atol 1e-5: the two
             devices sum in different orders across local steps), then the
             int8 uplink on the int8 arena and the ``--quantize`` downlink
             (every coordinate within one quantization step of its group
             plus 1e-5, fewer than 0.1% beyond rtol 1e-4 / atol 1e-5: an
             int8 code may flip by one where the sums differ); then a
             byzantine federation (16 learners, fault seed 7, ``scale`` and
             ``sign_flip`` adversaries, one dispatch worker so arrival order
             is fixed) under ``trimmed_mean`` and ``median`` (global buffer
             rtol 1e-4 / atol 1e-5; the adversarial, clipped, rejected and
             quarantine counters equal); then the protocols beside sync, one
             dispatch worker, no wall-clock timer: async on the f32 arena and
             on the stack store, FedBuff (K = 3 of 4) on the int8 arena with
             the int8 codec (the int8 bar), deadline cohorts and reputation
             (fraction 0.5) on a ``FaultyChannel`` losing and duplicating
             uploads (fault seed 7) — global buffer as above, every
             ``engine.faults.*`` and ``engine.uploads.*`` counter equal;
5. main    — housing-mlp-10m, 32 learners, 4 local steps of batch 100, ten
             legs and a diagnostic, each reached as users reach it, with
             its launch counts zeroed just before it and read just after:
             ``launch/train.main``
             (f32 arena, raw codec); the stack store through
             ``Driver``/``FederationEnv`` with a lineage of two models per
             learner; ``int8_arena`` (int8 uplink into the int8-resident
             arena, fused reduce); ``int8_wire`` (int8 uplink decoded onto
             the f32 arena); ``trimmed_mean`` (a ``Controller`` on a
             ``FaultyChannel`` with 8 byzantine learners, ``trim_k=8``, built
             as the reference's adversarial arm builds it; the
             sorting-network kernel once per round); ``median``
             (``FederationEnv(aggregation_rule="median")``, faultless;
             ``torch.sort``) — arena at 3 rounds, the other five at 2;
             ``semi_sync``
             (``launch/train.main --protocol semi_sync``, 2 rounds; round
             2's steps checked against the profiles); ``async``
             (``--protocol async``, 32 community updates plus the legs in
             flight at the end; some stale, the last update equal to its
             plain replay, the final eval loss within 1% of the arena
             leg's); ``buffered_async_int8`` (``Driver`` with
             ``buffer_k=8`` on the int8 codec and arena, 4 updates plus the
             legs in flight; 8 members an aggregate, every upload landed
             quantized, every reduce fused); ``deadline_32`` (the
             deadline leg below for one round at the default 32 dispatch
             workers, its fires printed, not required); ``deadline_faults`` (a
             ``Controller`` with ``DeadlineCohortProtocol`` and wall-clock
             timers at half the arena leg's median ``train_round_s`` and
             eight dispatch workers (a round's uploads come in waves), on a
             ``FaultyChannel`` losing and duplicating uploads, 3 rounds;
             the lost and duplicated counts equal the injector's fates for
             the dispatched pairs, the deadline fired, every late upload
             folded into the next round's reduce).

A disagreement found in the kernels or check phases is printed and recorded,
and the script goes on, so one call shows every fault; any recorded or
raised failure exits non-zero before the result line.  Without CUDA, or without
the repository's ``src/`` beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
# FP32 instructions issued per second on the CUDA cores (the 67 TFLOP/s
# figure counts an FMA as two operations); only for the network diagnostic.
F32_ISSUE_PER_S = F32_FLOPS / 2
P_MAIN = 10_174_464  # housing-mlp-10m row, padded to the arena's 1024 alignment
P_STACK = 10_174_081  # housing-mlp-10m params: the stack leg's unpadded rows
N_MAIN = 32
GROUP = 256
# Rounds per round-based leg.  The stack, int8_wire, int8_arena,
# trimmed_mean and median legs run 2 rounds (two is what keeps a lineage of
# two models per learner in the stack leg and overwrites every arena row
# once), so the legs stay inside 600 s of command time; every leg keeps its
# full width.  ``deadline_32`` is a one-round diagnostic.
LEG_ROUNDS = {"arena": 3, "stack": 2, "int8_arena": 2, "int8_wire": 2, "trimmed_mean": 2,
              "median": 2, "semi_sync": 2, "deadline_32": 1, "deadline_faults": 3}
ASYNC_UPDATES = 32  # the async leg's total_updates (one per learner)
FEDBUFF_K, FEDBUFF_UPDATES = 8, 4  # the buffered_async_int8 leg
# The deadline_faults leg's dispatch workers.  With 32 (the default, one per
# learner), a round's learners interleave on one interpreter and nearly all
# upload in its last few percent (``arrival_s``), so a deadline at half the
# round usually finds nothing arrived and is ignored; ``deadline_32`` runs
# that setting for one round and prints what it did.  Eight run the round
# in four waves, so half of it lands between the second and the third.
DEADLINE_WORKERS = 8
LOCAL_STEPS = 4
BATCH = 100
LR = 0.05
INT8_ROW_BYTES = 10_333_440  # wire_layout(P_MAIN): 10,174,464 int8 + 39,744 f32 scales
TRIM_K = 8  # covers the 8 byzantine learners fault seed 7 makes of 32 (2 * 8 < 32)
BYZANTINE = dict(seed=7, adversarial_fraction=0.15, adversarial_fates=("scale", "sign_flip"))
BYZ_COUNTERS = ("engine.faults.adversarial.scale", "engine.faults.adversarial.sign_flip",
                "engine.uploads.clipped", "engine.uploads.rejected.nonfinite",
                "engine.quarantine.entered")
FAULTS = dict(seed=7, upload_loss_rate=0.1, upload_dup_rate=0.1)
FAILURES: list[str] = []  # disagreements found by the kernels and check phases


def _expect(ok: bool, what: str) -> None:
    """Record (and print) a failed check; main() fails on any before its result."""
    if not ok:
        FAILURES.append(what)
        print(json.dumps({"failed": what}), flush=True)


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
    from repro_torch.kernels import fused_agg as kfu
    from repro_torch.kernels import quantize as kq
    from repro_torch.kernels import robust as krob

    full_f32()
    dev = torch.device("cuda")
    counters = {"masked_fedavg": kfed.masked_fedavg_cuda, "fedavg": kfed.fedavg_cuda,
                "quantize": kq.quantize_cuda, "dequantize": kq.dequantize_cuda,
                "masked_fedavg_q8": kfu.masked_fedavg_q8_cuda,
                "masked_trimmed_mean": krob.masked_trimmed_mean_cuda}

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
    errs.update(check_quantize(kq, dev))
    errs["masked_fedavg_q8"] = check_fused(kfu, dev)
    timing.update(time_int8_kernels(kq, kfu, dev, errs))
    errs["masked_trimmed_mean"] = check_trimmed_mean(krob, dev)
    timing.update(time_trimmed_mean(krob, dev, errs))
    print(json.dumps({"phase": "kernels", "seconds": time.perf_counter() - t_phase}),
          flush=True)

    # -- 4. check: the card agrees with the host on small federations --------
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    small = ["--arch", "housing-mlp", "--size", "100k", "--learners", "4",
             "--rounds", "2", "--local-steps", "2", "--batch-size", "100",
             "--lr", "0.01", "--seed", "0"]
    d_gpu, _ = train.main(small + ["--device", "cuda"])
    d_cpu, _ = train.main(small + ["--device", "cpu"])
    g = d_gpu.controller.global_buffer.cpu()
    h = d_cpu.controller.global_buffer
    checks = {"f32": _close(g, h, 1e-4, atol=1e-5, what="check f32 card vs host")}
    small_fed = dict(size="100k", learners=4, rounds=2, local_steps=2, lr=0.01)
    d_gpu, _ = run_federation(train, dev, upload_codec="int8", arena_dtype="int8", **small_fed)
    d_cpu, _ = run_federation(train, torch.device("cpu"), upload_codec="int8",
                              arena_dtype="int8", **small_fed)
    assert d_gpu.controller.arena.buffer.dtype == torch.int8
    checks["int8_arena"] = within_q8_bar(d_gpu.controller.global_buffer.cpu(),
                                         d_cpu.controller.global_buffer, "check int8_arena")
    d_gpu, _ = train.main(small + ["--quantize", "--device", "cuda"])
    d_cpu, _ = train.main(small + ["--quantize", "--device", "cpu"])
    assert d_gpu.controller.channel.codec is not None
    checks["quantize_downlink"] = within_q8_bar(d_gpu.controller.global_buffer.cpu(),
                                                d_cpu.controller.global_buffer,
                                                "check quantize downlink")
    small_byz = dict(size="100k", learners=16, rounds=3, local_steps=2, lr=0.01,
                     trim_k=6, workers=1)
    for rule in ("trimmed_mean", "median"):
        c_gpu, _ = run_byzantine(train, dev, rule=rule, **small_byz)
        c_cpu, _ = run_byzantine(train, torch.device("cpu"), rule=rule, **small_byz)
        checks[f"byzantine_{rule}"] = _close(c_gpu.global_buffer.cpu(), c_cpu.global_buffer,
                                             1e-4, atol=1e-5, what=f"check byzantine {rule}")
        on_card = {k: c_gpu.telemetry.value(k) for k in BYZ_COUNTERS}
        on_host = {k: c_cpu.telemetry.value(k) for k in BYZ_COUNTERS}
        _expect(on_card == on_host,
                f"check byzantine {rule}: counters {on_card} on the card, {on_host} on the host")
        _expect(on_card["engine.faults.adversarial.scale"] > 0
                and on_card["engine.faults.adversarial.sign_flip"] > 0,
                f"check byzantine {rule}: no adversarial upload in {on_card}")
        print(json.dumps({"phase": "check", "byzantine": rule, "counters": on_card}),
              flush=True)
    # The continuous and fault-enacting protocols: one dispatch worker fixes
    # the arrival order, no wall-clock timer; the deadline is far beyond any
    # predicted finish (prediction reads measured step times, which differ
    # between the card and the host).
    from repro_torch.core import (AsyncProtocol, BufferedAsyncProtocol,
                                  DeadlineCohortProtocol, ReputationProtocol)

    task = dict(local_steps=2, batch_size=BATCH, learning_rate=0.01)
    protocol_checks = {
        "async_arena": dict(protocol=AsyncProtocol(**task), learners=4, updates=6),
        "async_stack": dict(protocol=AsyncProtocol(**task), learners=4, updates=6,
                            store_mode="stack"),
        "buffered_async_int8": dict(protocol=BufferedAsyncProtocol(buffer_k=3, **task),
                                    learners=4, updates=2, upload_codec="int8",
                                    arena_dtype="int8"),
        "deadline_faults": dict(protocol=DeadlineCohortProtocol(
            deadline_s=1e6, enforce_wall_clock=False, **task), learners=8, rounds=2,
            faults=FAULTS),
        "reputation_faults": dict(protocol=ReputationProtocol(fraction=0.5, **task),
                                  learners=8, rounds=2, faults=FAULTS),
    }
    for name, kw in protocol_checks.items():
        c_gpu, _ = run_controller(train, dev, lr=0.01, **kw)
        c_cpu, _ = run_controller(train, torch.device("cpu"), lr=0.01, **kw)
        g, h = c_gpu.global_buffer.cpu(), c_cpu.global_buffer
        if kw.get("upload_codec") == "int8":
            checks[name] = within_q8_bar(g, h, f"check {name}")
        else:
            checks[name] = _close(g, h, 1e-4, atol=1e-5, what=f"check {name}")
        on_card, on_host = _engine_counters(c_gpu), _engine_counters(c_cpu)
        _expect(on_card == on_host,
                f"check {name}: counters {on_card} on the card, {on_host} on the host")
        print(json.dumps({"phase": "check", "protocol": name, "counters": on_card,
                          "model_version": c_gpu.telemetry.value("controller.model_version")}),
              flush=True)
    print(json.dumps({"phase": "check", "max_abs_err_vs_host": checks,
                      "seconds": time.perf_counter() - t_phase}), flush=True)
    del d_gpu, d_cpu, c_gpu, c_cpu

    # -- 5. main path ---------------------------------------------------------
    def launcher(rounds: int, *extra: str) -> list[str]:
        return ["--arch", "housing-mlp", "--size", "10m", "--learners", str(N_MAIN),
                "--rounds", str(rounds), "--local-steps", str(LOCAL_STEPS),
                "--batch-size", str(BATCH), "--lr", str(LR), "--seed", "0",
                "--device", "cuda", *extra]

    def fed(leg: str) -> dict:
        return dict(size="10m", learners=N_MAIN, rounds=LEG_ROUNDS[leg],
                    local_steps=LOCAL_STEPS, lr=LR)

    train_round_s: dict[str, list[float]] = {}
    first_step_s: dict[str, float] = {}  # each learner's first seconds_per_step

    def deadline_leg(leg: str, workers: int):
        # D: half the arena leg's median train_round_s in this run.
        deadline = 0.5 * statistics.median(train_round_s["arena"])
        print(json.dumps({"phase": f"main.{leg}", "deadline_s": deadline,
                          "dispatch_workers": workers}), flush=True)
        protocol = DeadlineCohortProtocol(deadline_s=deadline, local_steps=LOCAL_STEPS,
                                          batch_size=BATCH, learning_rate=LR,
                                          enforce_wall_clock=True)
        return run_controller(train, dev, protocol, N_MAIN, rounds=LEG_ROUNDS[leg],
                              size="10m", lr=LR, faults=FAULTS, workers=workers,
                              record_selected=True)

    legs = {
        "arena": lambda: _controller(train.main(launcher(LEG_ROUNDS["arena"]))),
        "stack": lambda: _controller(run_federation(train, dev, lineage_length=2,
                                                    **fed("stack"))),
        "int8_arena": lambda: _controller(run_federation(train, dev, upload_codec="int8",
                                                         arena_dtype="int8", **fed("int8_arena"))),
        "int8_wire": lambda: _controller(run_federation(train, dev, upload_codec="int8",
                                                        **fed("int8_wire"))),
        "trimmed_mean": lambda: run_byzantine(train, dev, rule="trimmed_mean", trim_k=TRIM_K,
                                              **fed("trimmed_mean")),
        "median": lambda: _controller(run_federation(train, dev, aggregation_rule="median",
                                                     **fed("median"))),
        "semi_sync": lambda: _spy_first_step_times(first_step_s, lambda: _controller(
            train.main(launcher(LEG_ROUNDS["semi_sync"], "--protocol", "semi_sync")))),
        "async": lambda: _controller(train.main(launcher(ASYNC_UPDATES, "--protocol", "async"))),
        "buffered_async_int8": lambda: _controller(run_federation(
            train, dev, protocol="buffered_async", buffer_k=FEDBUFF_K, upload_codec="int8",
            arena_dtype="int8", **{**fed("arena"), "rounds": FEDBUFF_UPDATES})),
        "deadline_32": lambda: deadline_leg("deadline_32", N_MAIN),
        "deadline_faults": lambda: deadline_leg("deadline_faults", DEADLINE_WORKERS),
    }

    def expected(leg: str, c, history) -> dict:
        """The launches each leg must make, from its own counts."""
        rounds = len(history)
        uploads = c.telemetry.value("channel.upload_messages")
        return {
            "arena": {"masked_fedavg": rounds},
            "stack": {"fedavg": rounds},
            "int8_arena": {"quantize": N_MAIN * rounds, "masked_fedavg_q8": rounds},
            "int8_wire": {"quantize": N_MAIN * rounds, "dequantize": N_MAIN * rounds,
                          "masked_fedavg": rounds},
            "trimmed_mean": {"masked_trimmed_mean": rounds},
            "median": {},
            "semi_sync": {"masked_fedavg": rounds},
            "async": {"masked_fedavg": rounds},  # one per community update
            "buffered_async_int8": {"quantize": uploads, "masked_fedavg_q8": rounds},
            "deadline_32": {"masked_fedavg": rounds},
            "deadline_faults": {"masked_fedavg": rounds},
        }[leg]

    launches = dict.fromkeys(counters, 0)
    resident = {}
    eval_loss = {}
    for leg, run in legs.items():
        for fn in counters.values():
            fn.launches = 0
        t_phase = time.perf_counter()
        c, history = run()
        counts = {name: fn.launches for name, fn in counters.items()}
        continuous = leg in ("async", "buffered_async_int8")
        if continuous:
            agg = [h_.aggregation_s for h_ in history]
            print(json.dumps({"phase": f"main.{leg}", "updates": len(history),
                              "aggregation_s": [min(agg), statistics.median(agg), max(agg)]}),
                  flush=True)
            assert len(history) >= (ASYNC_UPDATES if leg == "async" else FEDBUFF_UPDATES)
        else:
            eval_loss[leg] = [h_.metrics["eval_loss"] for h_ in history]
            train_round_s[leg] = [h_.train_round_s for h_ in history]
            for h_ in history:
                print(json.dumps({"phase": f"main.{leg}", "round": h_.round_id,
                                  "aggregation_s": h_.aggregation_s,
                                  "federation_round_s": h_.federation_round_s,
                                  "train_round_s": h_.train_round_s,
                                  "eval_round_s": h_.eval_round_s,
                                  "eval_loss": h_.metrics["eval_loss"]}), flush=True)
                assert math.isfinite(h_.metrics["eval_loss"]), h_.metrics
            assert len(history) == LEG_ROUNDS[leg], len(history)
        rounds = len(history)
        want = {**dict.fromkeys(counters, 0), **expected(leg, c, history)}
        assert counts == want, (leg, counts, want)
        up = c.channel.stats.upload_bytes
        tel = c.telemetry
        if leg == "stack":
            assert c.arena is None and c.store_mode == "stack"
            assert up == N_MAIN * rounds * 4 * P_STACK, up
        else:
            arena = c.arena
            resident[leg] = tel.value("store.arena.bytes_resident")
            assert arena.buffer.device.type == "cuda", arena.buffer.device
            assert tuple(arena.buffer.shape) == (N_MAIN, P_MAIN), arena.buffer.shape
        if leg == "arena":
            assert c.arena.buffer.dtype == torch.float32
            assert up == N_MAIN * rounds * 4 * P_MAIN, up
        if leg.startswith("int8"):
            assert up == N_MAIN * rounds * INT8_ROW_BYTES, up
            direct = N_MAIN * rounds if leg == "int8_arena" else 0
            assert tel.value("engine.uploads.quantized_direct") == direct
            assert tel.value("controller.aggregations.fused_q8") == (rounds if direct else 0)
        if leg == "trimmed_mean":
            byz = {k: tel.value(k) for k in BYZ_COUNTERS}
            assert c.aggregation_rule == "trimmed_mean" and c.trim_k == TRIM_K
            assert byz["engine.faults.adversarial.scale"] > 0, byz
            assert byz["engine.faults.adversarial.sign_flip"] > 0, byz
            # Arrival order decides which uploads precede the screen's warm-up.
            assert 0 < byz["engine.uploads.clipped"] <= byz["engine.faults.adversarial.scale"], byz
            print(json.dumps({"phase": "main.trimmed_mean", "counters": byz}), flush=True)
        if leg == "median":
            assert c.aggregation_rule == "median"
        if leg == "int8_arena":
            assert c.arena.buffer.dtype == torch.int8
            assert c.arena.scales.dtype == torch.float32
            assert c.arena.scales.device.type == "cuda"
            assert tuple(c.arena.scales.shape) == (N_MAIN, P_MAIN // GROUP)
            shrink = resident["arena"] / resident["int8_arena"]
            assert 3.8 < shrink < 4.0, shrink
        if leg == "semi_sync":
            check_semi_sync(c, first_step_s)
        if leg == "async":
            eval_loss[leg] = [check_async(c, eval_loss["arena"][-1], kfed)]
        if leg == "buffered_async_int8":
            check_fedbuff(c, history)
        if leg.startswith("deadline"):
            check_deadline_faults(c, leg, must_fire=leg == "deadline_faults")
        assert torch.isfinite(c.global_buffer).all()
        for name, v in counts.items():
            launches[name] += v
        # Where a round's time goes, from the run's own telemetry: summed
        # host seconds of each wire half (across learner threads, so they
        # overlap) and the learners' EWMA seconds per local step.
        steps = [p["seconds_per_step"] for p in c._learner_profiles.values()
                 if "seconds_per_step" in p]
        print(json.dumps({"phase": f"main.{leg}", "breakdown": {
            "broadcast_serialize_s": tel.value("channel.serialize_s"),
            "learner_recv_s": tel.value("channel.deserialize_s"),
            "learner_upload_encode_s": tel.value("channel.upload_serialize_s"),
            "controller_upload_decode_s": tel.value("channel.upload_deserialize_s"),
            "seconds_per_step_mean": statistics.fmean(steps),
            "aggregate_s_mean": tel.value("engine.aggregate_s"),
            "round_s_mean": tel.value("engine.round_s"),
            "arrival_s": _arrival_offsets(c)}}), flush=True)
        print(json.dumps({"phase": f"main.{leg}", "launches": counts,
                          "upload_bytes": up,
                          "upload_messages": tel.value("channel.upload_messages"),
                          "upload_meta_bytes": c.channel.stats.upload_meta_bytes,
                          "bytes_resident": resident.get(leg),
                          "quantized_direct": tel.value("engine.uploads.quantized_direct"),
                          "fused_q8": tel.value("controller.aggregations.fused_q8"),
                          "engine": _engine_counters(c),
                          "global_buffer": list(c.global_buffer.shape),
                          "seconds": time.perf_counter() - t_phase}), flush=True)
        del history, c
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "main", "eval_loss_by_round": eval_loss}), flush=True)

    if FAILURES:
        sys.exit(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}")
    rows = []
    for name, source, replaces in (
        ("masked_fedavg", "fedavg.cu", "src/repro/kernels/fedavg.py:181"),
        ("fedavg", "fedavg.cu", "src/repro/kernels/fedavg.py:126"),
        ("quantize", "quantize.cu", "src/repro/kernels/quantize.py:105"),
        ("dequantize", "quantize.cu", "src/repro/kernels/quantize.py:143"),
        ("masked_fedavg_q8", "fused_agg.cu", "src/repro/kernels/fused_agg.py:150"),
        ("masked_trimmed_mean", "robust.cu", "src/repro/kernels/robust.py:80"),
    ):
        assert launches[name] > 0, (name, launches)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], **timing[name],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def _controller(run: tuple) -> tuple:
    """``(driver, history)`` -> ``(controller, history)``."""
    driver, history = run
    return driver.controller, history


def run_controller(train, dev, protocol, learners, rounds=0, updates=0, size="100k", lr=0.01,
                   faults=None, workers=1, record_selected=False, **ctrl_kw):
    """A ``Controller`` built directly, with the launcher's learners (same
    model, data and seed as ``train.main``), on a ``FaultyChannel`` when
    ``faults`` is a ``FaultSpec``'s fields; runs ``rounds`` rounds or
    ``updates`` community updates.  ``record_selected`` keeps each round
    aggregate's learner list at ``controller.selected``.  Returns
    ``(controller, history)``; the controller is shut down."""
    from repro_torch import optim
    from repro_torch.core import Controller, FaultInjector, FaultSpec, FaultyChannel
    from repro_torch.models import mlp as mlp_model

    cfg, fleet = train.build_housing_learners(size, learners, seed=0,
                                              optimizer=optim.sgd(lr), device=dev)
    initial = mlp_model.init_params(torch.Generator().manual_seed(0), cfg, dev)
    channel = None
    if faults is not None:
        channel = FaultyChannel(FaultInjector(FaultSpec(**faults)), device=dev)
    ctrl = Controller(protocol=protocol, channel=channel, arena_n_max=learners,
                      max_dispatch_workers=workers, device=dev, **ctrl_kw)
    ctrl.set_initial_model(initial)
    for learner in fleet:
        ctrl.register_learner(learner)
    if record_selected:
        ctrl.selected = []
        aggregate_round = ctrl.aggregate_round

        def recording(selected):
            ctrl.selected.append(list(selected))
            return aggregate_round(selected)

        ctrl.aggregate_round = recording
    try:
        if updates:
            history = ctrl.engine.run(total_updates=updates)
        else:
            history = ctrl.engine.run(rounds=rounds)
    finally:
        ctrl.shutdown()
    return ctrl, history


def run_byzantine(train, dev, size, learners, rounds, local_steps, lr, rule, trim_k,
                  workers=32):
    """Sync rounds on a ``FaultyChannel`` with byzantine learners, built as the
    reference's adversarial arm builds it (``benchmarks/bench_round.py``)."""
    from repro_torch.core import SyncProtocol

    return run_controller(train, dev, SyncProtocol(local_steps, BATCH, lr), learners,
                          rounds=rounds, size=size, lr=lr, faults=BYZANTINE, workers=workers,
                          aggregation_rule=rule, trim_k=trim_k)


def run_federation(train, dev, size, learners, rounds, local_steps, lr, **env):
    """One federation as users reach it: ``Driver``/``FederationEnv`` with the
    launcher's learners (same model, data and seed as ``launch/train.main``).

    ``lineage_length=2`` makes the Driver pick the stack store;
    ``upload_codec``/``arena_dtype`` select the int8 legs,
    ``aggregation_rule`` the robust rules, ``protocol`` (sync by default) the
    workflow; a continuous one runs ``rounds`` community updates.
    """
    from repro_torch import optim
    from repro_torch.core import Driver, FederationEnv, TerminationCriteria
    from repro_torch.models import mlp as mlp_model

    cfg, fleet = train.build_housing_learners(size, learners, seed=0,
                                              optimizer=optim.sgd(lr), device=dev)
    initial = mlp_model.init_params(torch.Generator().manual_seed(0), cfg, dev)
    driver = Driver(FederationEnv(local_steps=local_steps, batch_size=BATCH, learning_rate=lr,
                                  termination=TerminationCriteria(max_rounds=rounds),
                                  device=dev, **env))
    driver.initialize(initial, fleet)
    return driver, driver.run()


def _arrival_offsets(c) -> dict:
    """Per dispatch round: seconds from its first dispatch to its uploads
    (the first, the 10th, 25th and 50th percentiles and the last), off the
    journal's clock."""
    first, seen = {}, {}
    for r in c.journal.records():
        if r.get("kind") == "dispatch":
            first.setdefault(r["round"], r["t"])
        elif r.get("kind") == "upload" and r.get("round") in first:
            seen.setdefault(r["round"], []).append(r["t"] - first[r["round"]])
    def at(v, q):
        v = sorted(v)
        return v[min(len(v) - 1, int(q * len(v)))]

    return {str(k): [at(v, q) for q in (0.0, 0.1, 0.25, 0.5, 1.0)]
            for k, v in sorted(seen.items())}


def _engine_counters(c) -> dict:
    """Every ``engine.faults.*`` and ``engine.uploads.*`` counter of a run."""
    tel = c.telemetry
    return {k: tel.value(k) for k in sorted(tel.names())
            if k.startswith(("engine.faults.", "engine.uploads."))}


def _spy_first_step_times(seen: dict, run):
    """Run ``run()`` recording each learner's first measured seconds per step
    (what its EWMA profile holds until its second upload)."""
    from repro_torch.core.controller import Controller

    observe = Controller._observe

    def spy(self, update):
        seen.setdefault(update.learner_id, update.seconds_per_step)
        observe(self, update)

    Controller._observe = spy
    try:
        return run()
    finally:
        Controller._observe = observe


def check_semi_sync(c, first_step_s: dict) -> None:
    """Round 2's dispatched steps equal ``max(1, int((hyperperiod_s - wire_s) /
    seconds_per_step))`` from the controller's profiles, learner by learner."""
    from repro_torch.core import Dispatched

    hp = c.protocol.hyperperiod_s
    sized = {}
    for e in c.engine.event_log:
        if isinstance(e, Dispatched) and e.round_id == 1:
            want = max(1, int((hp - c.wire_time_s(e.learner_id)) / first_step_s[e.learner_id]))
            assert e.task.local_steps == want, (e.learner_id, e.task.local_steps, want)
            sized[e.learner_id] = e.task.local_steps
    assert len(sized) == N_MAIN, sized
    print(json.dumps({"phase": "main.semi_sync", "hyperperiod_s": hp,
                      "round_2_local_steps": sized,
                      "wire_s": c.wire_time_s(next(iter(sized))),
                      "first_seconds_per_step": [min(first_step_s.values()),
                                                 statistics.median(first_step_s.values()),
                                                 max(first_step_s.values())]}), flush=True)


def check_async(c, arena_eval_loss: float, kfed) -> float:
    """Some community update folded a stale upload; the last community update
    equals its plain replay; the final model's eval loss over every learner is
    finite and within 1% of the arena leg's last (a sanity check only: every
    leg's losses read 19.0956-19.0998, so a wrong reduce would pass it)."""
    from repro_torch.core.aggregation import staleness_weights
    from repro_torch.core.engine import reduce_eval

    stale = [r["staleness"] for r in c.journal.records()
             if r.get("kind") == "upload" and "staleness" in r]
    assert max(stale) > 0, stale
    # Replay the last update in plain torch on the card: the arena's rows,
    # weights and versions are as that update read them (every arrival is
    # written, then reduced), at the model version before its commit.
    arena = c.arena
    stal = torch.clamp(float(c._model_version - 1) - arena.versions, min=0.0)
    alpha = c.protocol.staleness_alpha
    want = kfed.masked_fedavg_torch(arena.buffer, staleness_weights(arena.weights, stal, alpha),
                                    arena.mask)[: arena.num_params]
    diff = (c.global_buffer - want).abs()
    replay_err = float(diff.max())
    assert bool((diff <= 1e-5 + 1e-4 * want.abs()).all()), replay_err
    del want, diff
    loss = reduce_eval([learner.evaluate(c.global_params, c.round_id)
                        for learner in c._learners.values()])["eval_loss"]
    assert math.isfinite(loss) and abs(loss - arena_eval_loss) <= 0.01 * arena_eval_loss, (
        loss, arena_eval_loss)
    hist = {str(k): stale.count(k) for k in sorted(set(stale))}
    print(json.dumps({"phase": "main.async", "staleness_hist": hist, "eval_loss": loss,
                      "arena_eval_loss": arena_eval_loss,
                      "last_update_replay_max_abs_err": replay_err}), flush=True)
    return loss


def check_fedbuff(c, history) -> None:
    """Every aggregate folds exactly K members; every upload landed quantized
    and every aggregate was the fused int8 reduce."""
    from repro_torch.core import AggregateFired

    fired = [e for e in c.engine.event_log if isinstance(e, AggregateFired)]
    assert len(fired) == len(history) and all(len(e.members) == FEDBUFF_K for e in fired), [
        e.members for e in fired]
    tel = c.telemetry
    uploads = tel.value("channel.upload_messages")
    assert tel.value("engine.uploads.quantized_direct") == uploads, uploads
    assert tel.value("controller.aggregations.fused_q8") == len(history)
    assert uploads == FEDBUFF_K * len(history), (uploads, len(history))
    print(json.dumps({"phase": "main.buffered_async_int8", "aggregates": len(history),
                      "uploads": uploads}), flush=True)


def check_deadline_faults(c, leg: str, must_fire: bool) -> None:
    """Lost and duplicated uploads equal the injector's fates for the
    dispatched (learner, round) pairs; the deadline fired (where
    ``must_fire``; otherwise its fires are only printed); every late upload
    is folded into the next round's reduce (or is still owed, when it came
    after the last round)."""
    from repro_torch.core import (AggregateFired, Dispatched, FaultInjector, FaultSpec,
                                  UploadArrived)

    injector = FaultInjector(FaultSpec(**FAULTS))
    fates = [injector.upload_fate(e.learner_id, e.round_id) for e in c.engine.event_log
             if isinstance(e, Dispatched)]
    aggregates, late = 0, []
    for e in c.engine.event_log:
        if isinstance(e, AggregateFired):
            aggregates += 1
        elif (isinstance(e, UploadArrived) and not e.duplicate
              and e.update.upload.metadata.get("fault") != "lost"
              and e.update.round_id < aggregates):
            late.append((e.learner_id, aggregates))
    cohorts = [sum(1 for e in c.engine.event_log if isinstance(e, Dispatched) and e.round_id == r)
               for r in range(LEG_ROUNDS[leg])]
    print(json.dumps({"phase": f"main.{leg}", "cohorts": cohorts,
                      "lost": fates.count("lost"), "dup": fates.count("dup"),
                      "late": late, "reduced": [len(x) for x in c.selected],
                      "arrival_s": _arrival_offsets(c), "engine": _engine_counters(c)}),
          flush=True)
    tel = c.telemetry
    assert tel.value("engine.faults.uploads_lost") == fates.count("lost"), fates
    assert tel.value("engine.faults.uploads_duplicated") == fates.count("dup"), fates
    if must_fire:
        assert tel.value("engine.faults.deadline_fires") >= 1, _engine_counters(c)
    for lid, owed in late:
        if owed < len(c.selected):
            assert lid in c.selected[owed], (lid, owed, c.selected[owed])
        else:
            assert lid in c.engine._late_carry, (lid, c.engine._late_carry)


def within_q8_bar(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Every coordinate within one quantization step of its group (amax/127 of
    ``want``) plus 1e-5, fewer than 0.1% beyond rtol 1e-4 / atol 1e-5; returns
    the largest error."""
    got, want = got.double(), want.double()
    n = want.shape[0]
    padded = torch.nn.functional.pad(want.abs(), (0, (-n) % GROUP))
    step = padded.reshape(-1, GROUP).amax(1).repeat_interleave(GROUP)[:n] / 127.0
    err = (got - want).abs()
    beyond = float((err - step - 1e-5).max())
    _expect(beyond <= 0, f"{what}: {beyond} beyond one quantization step")
    loose = float((err > 1e-5 + 1e-4 * want.abs()).double().mean())
    _expect(loose < 1e-3, f"{what}: {loose} of coordinates beyond rtol 1e-4 / atol 1e-5")
    return float(err.max())


def _close(got: torch.Tensor, want: torch.Tensor, tol: float, atol: float | None = None,
           what: str = "") -> float:
    """Max abs error of ``got`` against ``want``; a miss of
    ``|got - want| <= atol + tol * |want|`` (NaN where ``want`` has none
    included) is recorded."""
    atol = tol if atol is None else atol
    diff = (got.double() - want.double()).abs()
    bad = int((~(diff <= atol + tol * want.double().abs())).sum())
    err = float(diff.nan_to_num(float("inf")).max())
    _expect(bad == 0, f"{what or 'kernel'}: {bad} elements beyond rtol={tol} atol={atol}, "
                      f"max abs err {err}")
    return err


def check_kernels(kfed, dev) -> dict:
    """Both FedAvg kernels against their plain versions at every listed shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"masked_fedavg": 0.0, "fedavg": 0.0}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        for n in (1, 7, 32, 64):
            for p in (1024, 50_001, P_STACK, P_MAIN):
                arena = (torch.randn((n, p), generator=gen, device=dev) * 3).to(dtype)
                w = torch.rand((n,), generator=gen, device=dev) + 0.05
                e_plain = _close(kfed.fedavg_cuda(arena, w), kfed.fedavg_torch(arena, w), tol,
                                 what=f"fedavg {dtype} {n}x{p}")
                # Every third row dead (none when n == 1), filled with NaN.
                m = torch.ones((n,), device=dev)
                m[1::3] = 0.0
                arena[m == 0] = float("nan")
                e_mask = _close(kfed.masked_fedavg_cuda(arena, w, m),
                                kfed.masked_fedavg_torch(arena, w, m), tol,
                                what=f"masked_fedavg {dtype} {n}x{p}")
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
        _expect(int(torch.count_nonzero(got)) == 0, "masked_fedavg: the empty mask must give 0")
        print(json.dumps({"phase": "kernels", "dtype": str(dtype),
                          "zero_weights_uniform": True, "empty_mask_zeros": True}),
              flush=True)
        # What the bulk-copy design opens: N past the old 1,024 staging limit
        # and past the 2,048 staging cap, a view whose data_ptr and rows are
        # not 16-byte aligned, widths under one 16-byte window; each launched
        # twice, bit-identical (no atomics).
        for n, p, view in ((1100, 777, False), (2500, 333, False), (32, 5001, True),
                           (7, 1, False), (7, 3, False), (7, 5, False)):
            arena = (torch.randn((n, p + view), generator=gen, device=dev) * 3).to(dtype)
            if view:
                arena = arena[:, 1:]
            w = torch.rand((n,), generator=gen, device=dev) + 0.05
            m = torch.ones((n,), device=dev)
            m[1::3] = 0.0
            got_u = kfed.fedavg_cuda(arena, w)
            _expect(_same_bits(got_u, kfed.fedavg_cuda(arena, w)),
                    f"fedavg {dtype} {n}x{p}: two launches differ")
            e_plain = _close(got_u, kfed.fedavg_torch(arena, w), tol,
                             what=f"fedavg {dtype} {n}x{p} view={view}")
            arena[m == 0] = float("nan")
            got = kfed.masked_fedavg_cuda(arena, w, m)
            _expect(_same_bits(got, kfed.masked_fedavg_cuda(arena, w, m)),
                    f"masked_fedavg {dtype} {n}x{p}: two launches differ")
            e_mask = _close(got, kfed.masked_fedavg_torch(arena, w, m), tol,
                            what=f"masked_fedavg {dtype} {n}x{p} view={view}")
            torch.cuda.synchronize()
            print(json.dumps({"phase": "kernels", "dtype": str(dtype), "n": n, "p": p,
                              "unaligned_view": view, "fedavg_err": e_plain,
                              "masked_err": e_mask, "tol": tol, "bit_identical": True}),
                  flush=True)
            if dtype == torch.float32:
                worst["fedavg"] = max(worst["fedavg"], e_plain)
                worst["masked_fedavg"] = max(worst["masked_fedavg"], e_mask)
        # One live row of 32, the other 31 NaN: the output is that row.
        arena = (torch.randn((32, 50_001), generator=gen, device=dev) * 3).to(dtype)
        m = torch.zeros((32,), device=dev)
        m[13] = 1.0
        arena[m == 0] = float("nan")
        w = torch.rand((32,), generator=gen, device=dev) + 0.05
        got = kfed.masked_fedavg_cuda(arena, w, m)
        _close(got, kfed.masked_fedavg_torch(arena, w, m), tol, what=f"masked_fedavg {dtype} one live")
        _close(got, arena[13].float(), 0.0, atol=0.0, what=f"masked_fedavg {dtype} one live row")
        print(json.dumps({"phase": "kernels", "dtype": str(dtype), "one_live_row_of": 32}),
              flush=True)
        del arena
    return worst


def special_input(size: int, group: int, seed: int) -> np.ndarray:
    """Normal data plus groups of zeros, subnormals, NaN, ±inf, a subnormal
    scale and huge values (the first eight groups)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(size, dtype=np.float32) * 5).astype(np.float32)
    x[:group] = 0.0
    x[group: 2 * group] = (rng.standard_normal(group) * 1e-39).astype(np.float32)
    x[2 * group + 3] = np.nan
    x[3 * group + 5] = np.inf
    x[4 * group + 7] = -np.inf
    x[5 * group: 6 * group] = (rng.standard_normal(group) * 1e-37).astype(np.float32)
    x[6 * group: 7 * group] *= np.float32(1e30)
    x[7 * group] = np.nan
    x[7 * group + 1] = np.inf
    return x


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_quantize(kq, dev) -> dict:
    """Quantize and dequantize against their plain versions: bit-identical
    ``q``, scales and output at every size and group, special groups included;
    ``ops.quantize`` reads the unpadded row (a last group of 129 at 100,225,
    tails at n = 1 and 7 mod 8) in one launch and writes the wire's layout,
    and the encoder's wire equals the plain version's bytes."""
    from repro_torch.core.transport import Int8UploadCodec
    from repro_torch.kernels import ops

    for size in (16_384, 100_000, 100_225, 100_001, 100_007, P_STACK, P_MAIN):
        for group in (256, 512):
            x = torch.from_numpy(special_input(size, group, seed=size + group)).to(dev)
            launches = kq.quantize_cuda.launches
            q, s = ops.quantize(x, group=group)  # pads to group * 64 like the reference
            one_launch = kq.quantize_cuda.launches == launches + 1
            pq, ps = kq.quantize_torch(x, group, q.shape[0])
            bad_q = int((q != pq).sum())
            bad_s = int((s.view(torch.int32) != ps.view(torch.int32)).sum())
            wire = kq.wire_prefix(q, s, s.shape[0])  # raises unless one buffer
            back = kq.dequantize_cuda(q, s, group)
            want = kq.dequantize_torch(q, s, group)
            bad_x = int((back.view(torch.int32) != want.view(torch.int32)).sum())
            torch.cuda.synchronize()
            print(json.dumps({"phase": "kernels", "quantize": size, "group": group,
                              "padded": q.shape[0], "wire_bytes": wire.shape[0],
                              "q_mismatch": bad_q, "scale_mismatch": bad_s,
                              "dequantize_mismatch": bad_x, "one_launch": one_launch,
                              "special_scales": s[:8].tolist()}), flush=True)
            _expect(bad_q == bad_s == bad_x == 0 and one_launch,
                    f"quantize/dequantize {size} group {group}: {bad_q} q, {bad_s} scales, "
                    f"{bad_x} dequantized values differ from the plain versions; "
                    f"one launch: {one_launch}")
            del x, q, s, wire, pq, ps, back, want
    codec = Int8UploadCodec()
    for size in (100_225, P_STACK):
        x = torch.from_numpy(special_input(size, GROUP, seed=size)).to(dev)
        n_padded, n_scales, nbytes = kq.wire_layout(size)
        pq, ps = kq.quantize_torch(x, GROUP, n_padded)
        want = kq.wire_prefix(pq, ps, n_scales).cpu().numpy()
        got = codec.encode(x)
        same = got.shape == (nbytes,) and bool((got == want).all())
        print(json.dumps({"phase": "kernels", "int8_encode": size, "wire_bytes": int(got.shape[0]),
                          "bit_identical": same}), flush=True)
        _expect(same, f"Int8UploadCodec.encode {size}: the wire differs from the plain bytes")
    return {"quantize": 0.0, "dequantize": 0.0}


def _q8_inputs(n: int, p: int, gen: torch.Generator, dev) -> tuple:
    q = torch.randint(-127, 128, (n, p), generator=gen, device=dev, dtype=torch.int8)
    s = torch.rand((n, p // GROUP), generator=gen, device=dev) * 5 + 0.01
    w = torch.rand((n,), generator=gen, device=dev) * 49 + 1
    return q, s, w


def check_fused(kfu, dev) -> float:
    """The fused dequant-into-aggregate against its plain version (2e-5)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for n in (1, 7, 32, 64):
        for p in (4096, 2304, P_MAIN):
            q, s, w = _q8_inputs(n, p, gen, dev)
            m = torch.ones((n,), device=dev)
            m[1::3] = 0.0
            err = _close(kfu.masked_fedavg_q8_cuda(q, s, w, m),
                         kfu.masked_fedavg_q8_torch(q, s, w, m), 2e-5,
                         what=f"masked_fedavg_q8 {n}x{p}")
            # Dead rows carrying garbage: NaN and 1e30 scales, saturated values.
            s[1::3] = float("nan")
            s[4::6] = 1e30
            q[m == 0] = 127
            got = kfu.masked_fedavg_q8_cuda(q, s, w, m)
            err = max(err, _close(got, kfu.masked_fedavg_q8_torch(q, s, w, m), 2e-5,
                                  what=f"masked_fedavg_q8 {n}x{p} dead-row garbage"))
            worst = max(worst, err)
            torch.cuda.synchronize()
            print(json.dumps({"phase": "kernels", "masked_fedavg_q8": [n, p],
                              "max_abs_err": err, "tol": 2e-5}), flush=True)
            del q, s
    n, p = 7, 2304
    q, s, _ = _q8_inputs(n, p, gen, dev)
    m = torch.ones((n,), device=dev)
    m[::2] = 0.0
    zero_w = torch.zeros((n,), device=dev)
    _close(kfu.masked_fedavg_q8_cuda(q, s, zero_w, m),  # uniform over valid rows
           kfu.dequant_rows(q, s)[m > 0].mean(0), 2e-5, what="masked_fedavg_q8 zero weights")
    got = kfu.masked_fedavg_q8_cuda(q, s, zero_w + 1, torch.zeros((n,), device=dev))
    _expect(int(torch.count_nonzero(got)) == 0, "masked_fedavg_q8: the empty mask must give 0")
    print(json.dumps({"phase": "kernels", "masked_fedavg_q8": "degenerate",
                      "zero_weights_uniform": True, "empty_mask_zeros": True}), flush=True)
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


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time on the card: the bytes the function must move (each input
    read once, each output written once) over the HBM rate, or its f32
    operations over the f32 peak, whichever is larger (ms)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def _timed(name: str, kern, plain, library, nbytes: float, flops: float, shape) -> dict:
    """Interleaved (plain, kernel, kernel, plain) so drift hits both alike."""
    t_plain_a = _time_ms(plain)
    t_kern_a = _time_ms(kern)
    t_kern_b = _time_ms(kern)
    t_plain_b = _time_ms(plain)
    t_lib = _time_ms(library) if library is not None else None
    bound_ms, bound_by = _bound(nbytes, flops)
    print(json.dumps({"phase": "kernels", "timed": name, "shape": shape,
                      "kernel_ms": [t_kern_a, t_kern_b], "plain_ms": [t_plain_a, t_plain_b],
                      "library_ms": t_lib, "bound_ms": bound_ms}), flush=True)
    return {"ms": min(t_kern_a, t_kern_b), "plain_ms": min(t_plain_a, t_plain_b),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t_lib}


def _count_device_kernels(name: str, fn, shape, calls: int = 10,
                          windows: int = 3) -> dict[str, int]:
    """Diagnostic: the device kernels (and copies) ``torch.profiler`` sees in
    ``calls`` wrapper calls, per call, and their summed device time per call;
    ``null`` where the profiler records no device activity.  The profiler has
    been seen to miss a record now and then, and a whole window once, never
    to add one; so up to ``windows`` windows are traced until one holds
    ``calls`` records, and the fullest is kept.  Returns the count of each
    kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names: dict[str, int] = {}
    device_us = 0.0
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen: dict[str, int] = {}
        us = 0.0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen[e.name] = seen.get(e.name, 0) + 1
                us += e.time_range.end - e.time_range.start
        if sum(seen.values()) > sum(names.values()):
            names, device_us = seen, us
        if sum(names.values()) >= calls:
            break
    total = sum(names.values())
    print(json.dumps({"phase": "kernels", "diagnostic": f"{name} device kernels per call",
                      "shape": shape, "per_call": total / calls if total else None,
                      "device_us_per_call": device_us / calls if total else None,
                      "kernels": names}), flush=True)
    return names


def _one_kernel_a_call(what: str, names: dict[str, int], kernel: str, calls: int) -> None:
    """Record a failure unless the profiler saw one kernel, ``kernel``, once a
    call (one missed record of ``calls`` accepted, as above)."""
    seen = sum(names.values())
    _expect(len(names) == 1 and kernel in next(iter(names)) and calls - 1 <= seen <= calls,
            f"{what}: the profiler saw {names} in {calls} calls, not one {kernel} a call")


def _host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call over ``calls`` calls with no synchronize
    between them (what the wrapper costs the learner's thread)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def time_kernels(kfed, dev, errs: dict) -> dict:
    """Kernel, plain and library times at the shapes the main path gives each
    FedAvg kernel: the arena's (32, 10,174,464) f32 and the stack's
    (32, 10,174,081).  Each kernel is first held against its plain version on
    the very inputs it is timed on; the error joins the kernel's worst."""
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
        errs[name] = max(errs[name], _close(kern(), plain(), 1e-5, what=f"{name} timed inputs"))
        _expect(_same_bits(kern(), kern()), f"{name}: two launches differ on the timed inputs")
        out[name] = _timed(name, kern, plain, lambda: torch.mv(rows.T, w_hat),
                           N_MAIN * p * 4 + 4 * p + 8 * N_MAIN, 2 * N_MAIN * p, [N_MAIN, p])
        _count_device_kernels(name, kern, [N_MAIN, p])
        if name == "masked_fedavg":
            # Diagnostic: dead rows are never loaded, so 16 dead of 32 should
            # take about half the all-live time (in turns: live, dead, dead, live).
            half = m.clone()
            half[1::2] = 0.0
            dead = lambda: kfed.masked_fedavg_cuda(rows, w, half)  # noqa: E731
            _close(dead(), kfed.masked_fedavg_torch(rows, w, half), 1e-5,
                   what="masked_fedavg 16 of 32 dead")
            live_a, dead_a, dead_b, live_b = (_time_ms(f) for f in (kern, dead, dead, kern))
            print(json.dumps({"phase": "kernels", "diagnostic": "masked_fedavg 16 of 32 rows dead",
                              "shape": [N_MAIN, p], "ms_16_dead": [dead_a, dead_b],
                              "ms_all_live": [live_a, live_b],
                              "ratio": min(dead_a, dead_b) / min(live_a, live_b),
                              "bound_ms_16_dead": _bound(16 * p * 4 + 4 * p + 8 * N_MAIN,
                                                         2 * 16 * p)[0]}), flush=True)
        del rows
        torch.cuda.empty_cache()
    return out


def time_int8_kernels(kq, kfu, dev, errs: dict) -> dict:
    """The int8 kernels at the main path's shapes: quantize as every upload's
    encode calls it, ``ops.quantize`` on one learner's unpadded (10,174,081,)
    row at group 256, and dequantize on the (10,174,464,) int8 row and its
    (39,744,) scales (the int8-wire leg's decode), each on 8 inputs in
    rotation (325 MB and 83 MB, so no call finds its input in the 50 MB L2);
    the fused reduce on the (32, 10,174,464) int8 arena with its (32, 39,744)
    scales.  Each is held against its plain version on the very inputs it is
    timed on first."""
    from repro_torch.core.transport import Int8UploadCodec
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    p, groups = P_MAIN, P_MAIN // GROUP
    xs = [torch.randn((P_STACK,), generator=gen, device=dev) * 3 for _ in range(8)]
    for x in xs:
        q, s = ops.quantize(x)
        pq, ps = kq.quantize_torch(x, GROUP, p)
        _expect(torch.equal(q, pq) and _same_bits(s, ps), "quantize differs on the timed inputs")
    turn = itertools.cycle(xs)
    kern = lambda: ops.quantize(next(turn))  # noqa: E731
    out["quantize"] = _timed("quantize", kern, lambda: kq.quantize_torch(next(turn), GROUP, p),
                             None, 4 * P_STACK + p + 4 * groups, 6 * P_STACK, [P_STACK])
    _one_kernel_a_call("ops.quantize", _count_device_kernels("ops.quantize", kern, [P_STACK],
                                                             calls=20), "quantize_kernel", 20)
    codec = Int8UploadCodec()
    _count_device_kernels("Int8UploadCodec.encode", lambda: codec.encode(next(turn)),
                          [P_STACK], calls=5)
    print(json.dumps({"phase": "kernels", "diagnostic": "ops.quantize host us per call",
                      "shape": [P_STACK], "host_us": _host_us(kern)}), flush=True)
    qs = [kq.quantize_cuda(x, GROUP, p) for x in xs]
    del xs, turn, kern
    for q, s in qs:
        _expect(_same_bits(kq.dequantize_cuda(q, s, GROUP), kq.dequantize_torch(q, s, GROUP)),
                "dequantize differs on the timed inputs")
    qg = qs[0][0].view(groups, GROUP)
    _expect(_same_bits(torch.mul(qg, qs[0][1][:, None]).reshape(-1),
                       kq.dequantize_torch(*qs[0], GROUP)),
            "the library dequantize differs from the plain version")
    turn = itertools.cycle(qs)

    def library():
        q, s = next(turn)
        return torch.mul(q.view(groups, GROUP), s[:, None])

    kern = lambda: kq.dequantize_cuda(*next(turn), GROUP)  # noqa: E731
    out["dequantize"] = _timed("dequantize", kern,
                               lambda: kq.dequantize_torch(*next(turn), GROUP), library,
                               p + 4 * groups + 4 * p, p, [p])
    print(json.dumps({"phase": "kernels", "diagnostic": "dequantize_cuda host us per call",
                      "shape": [p], "host_us": _host_us(kern)}), flush=True)
    del qs, qg, turn, kern
    aq, ascale, w = _q8_inputs(N_MAIN, p, gen, dev)
    m = torch.ones((N_MAIN,), device=dev)
    kern = lambda: kfu.masked_fedavg_q8_cuda(aq, ascale, w, m)  # noqa: E731
    plain = lambda: kfu.masked_fedavg_q8_torch(aq, ascale, w, m)  # noqa: E731
    errs["masked_fedavg_q8"] = max(errs["masked_fedavg_q8"],
                                   _close(kern(), plain(), 2e-5, what="q8 timed inputs"))
    out["masked_fedavg_q8"] = _timed(
        "masked_fedavg_q8", kern, plain, None,
        N_MAIN * p + 4 * N_MAIN * groups + 4 * p + 8 * N_MAIN, 3 * N_MAIN * p, [N_MAIN, p])
    del aq, ascale
    torch.cuda.empty_cache()
    return out


def _trimmed_rows(n: int, p: int, gen: torch.Generator, dev, dead: bool) -> tuple:
    """Normal rows with a duplicated and a negated row, a block of all-equal
    columns, a column of ±0 and, when ``dead``, every third row dead holding
    NaN or 1e30."""
    rows = torch.randn((n, p), generator=gen, device=dev) * 3
    if n >= 4:
        rows[n // 2] = rows[0]
        rows[n // 2 + 1] = -rows[1]
    rows[:, : p // 8] = 0.5
    rows[::2, p // 8] = 0.0
    rows[1::2, p // 8] = -0.0
    m = torch.ones((n,), device=dev)
    if dead:
        m[2::3] = 0.0
        rows[2::3] = float("nan")
        rows[5::6] = 1e30
    return rows, m


def check_trimmed_mean(krob, dev) -> float:
    """The masked trimmed mean against its plain version: N from 2 to 1000,
    at every size where the network's template changes (4, 8, 16, 32, 64)
    and on both sides of it, and past 64 where the rank-select takes over,
    with ``trim_k`` at 0 or 1, middling and its largest (``2·trim_k = N − 1``
    for odd N); every mask all-valid and with dead garbage rows; f32, and bf16
    at a subset; full width at N = 3, 8, 16, 32 and 64 (at N = 64 the row
    offsets pass 2^31 bytes); atol 1e-5, plus rtol 1e-5 at full width.
    (1000, 10,174,464) is left out: that arena alone is 40 GB and the plain
    sort needs three times as much.  Returns the worst f32 error."""
    gen = torch.Generator(device=dev).manual_seed(4)
    grid = {2: (0,), 3: (0, 1), 4: (0, 1), 5: (1, 2), 8: (1, 3), 16: (0, 4, 7), 17: (1, 4, 8),
            31: (0, 8, 15), 32: (1, 8, 15), 33: (1, 8, 16), 63: (0, 16, 31), 64: (1, 16, 31),
            65: (1, 16, 32), 1000: (1, 150, 499)}
    full_width = (3, 8, 16, 32, 64)
    worst = 0.0
    for n, trims in grid.items():
        for p in (1024, 5000, P_MAIN):
            if p == P_MAIN and n not in full_width:
                continue
            rtol = 1e-5 if p == P_MAIN else 0.0
            for dead in (False, True):
                rows, m = _trimmed_rows(n, p, gen, dev, dead)
                for trim_k in trims:
                    err = _close(krob.masked_trimmed_mean_cuda(rows, m, trim_k),
                                 krob.masked_trimmed_mean_torch(rows, m, trim_k), rtol,
                                 atol=1e-5, what=f"masked_trimmed_mean {n}x{p} trim_k={trim_k} "
                                                 f"dead={dead}")
                    worst = max(worst, err)
                torch.cuda.synchronize()
                print(json.dumps({"phase": "kernels", "masked_trimmed_mean": [n, p],
                                  "trim_k": list(trims), "dead_rows": dead,
                                  "max_abs_err": worst, "atol": 1e-5, "rtol": rtol}), flush=True)
                del rows
    # bf16 rows, widened exactly to f32
    for n, p in ((4, 5000), (5, 5000), (8, 5000), (17, 5000), (33, 5000), (64, 5000),
                 (65, 5000), (32, P_MAIN), (64, P_MAIN)):
        rows, m = _trimmed_rows(n, p, gen, dev, dead=True)
        rows = rows.to(torch.bfloat16)
        for trim_k in sorted({1, n // 4, (n - 1) // 2}):
            err = _close(krob.masked_trimmed_mean_cuda(rows, m, trim_k),
                         krob.masked_trimmed_mean_torch(rows, m, trim_k), 1e-5, atol=1e-5,
                         what=f"masked_trimmed_mean bf16 {n}x{p} trim_k={trim_k}")
            print(json.dumps({"phase": "kernels", "masked_trimmed_mean": [n, p],
                              "dtype": "bfloat16", "trim_k": trim_k, "max_abs_err": err}),
                  flush=True)
        del rows
    rows, _ = _trimmed_rows(8, 5000, gen, dev, dead=False)
    two = torch.zeros((8,), device=dev)
    two[[0, 5]] = 1.0  # degenerate cohort: falls back to the untrimmed mean
    _close(krob.masked_trimmed_mean_cuda(rows, two, 2), (rows[0] + rows[5]) / 2, 0.0,
           atol=1e-5, what="masked_trimmed_mean degenerate cohort")
    got = krob.masked_trimmed_mean_cuda(rows, torch.zeros((8,), device=dev), 2)
    _expect(int(torch.count_nonzero(got)) == 0,
            "masked_trimmed_mean: the empty mask must give 0")
    try:
        krob.masked_trimmed_mean_cuda(rows, two, 4)
        _expect(False, "masked_trimmed_mean: 2*trim_k >= N must raise ValueError")
    except ValueError:
        pass
    # NaN (either sign) in live rows and +inf meeting -inf: NaN last, as the
    # plain version puts it on the host and, since it makes NaN positive
    # before its sort, on the card.
    rows[2::3] = float("nan")
    rows[4::5] = -float("nan")
    rows[1, :500] = float("inf")
    rows[3, 300:900] = -float("inf")
    for trim_k in (1, 3):
        for mask in (torch.ones((8,), device=dev), two):
            got = krob.masked_trimmed_mean_cuda(rows, mask, trim_k).cpu()
            for where, want in (
                    ("host", krob.masked_trimmed_mean_torch(rows.cpu(), mask.cpu(), trim_k)),
                    ("card", krob.masked_trimmed_mean_torch(rows, mask, trim_k).cpu())):
                same = ((got == want) | ((got - want).abs() <= 1e-5)
                        | (torch.isnan(got) & torch.isnan(want)))
                _expect(bool(same.all()), f"masked_trimmed_mean NaN rows trim_k={trim_k} "
                                          f"vs plain on the {where}: "
                                          f"{int((~same).sum())} columns differ")
    print(json.dumps({"phase": "kernels", "masked_trimmed_mean": "degenerate",
                      "fallback_mean": True, "empty_mask_zeros": True,
                      "trim_k_value_error": True, "nan_in_live_rows": True}), flush=True)
    return worst


def _sorting_network_size(n: int) -> int:
    """Compare-exchanges of Batcher's odd-even merge sort on ``n`` inputs,
    ``n`` rounded up to 2^t: (t² − t + 4)·2^(t−2) − 1 (191 for 32)."""
    t = max(n - 1, 0).bit_length()
    return ((t * t - t + 4) << t) // 4 - 1


def time_trimmed_mean(krob, dev, errs: dict) -> dict:
    """The kernel on the main path's (32, 10,174,464) f32 arena at ``trim_k``
    8 (the main leg's, the row's numbers) and 1, and the device kernels the
    profiler sees per call (must be 1).  Its bound is the larger of the bytes
    (the arena read once, the output written once) and the least operations
    the function needs: per column a sorting network's compare-exchanges (a
    min and a max each) and the band's adds, over 67 TFLOP/s.  The network's
    own instructions a column (the min and max of each compare-exchange, a
    load and a predicated add a row) print apart as a diagnostic, at the FP32
    pipes' issue rate and at half of it.  No single PyTorch call computes a
    masked trimmed mean, so ``library_ms`` is null."""
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = torch.randn((N_MAIN, P_MAIN), generator=gen, device=dev) * 3
    m = torch.ones((N_MAIN,), device=dev)
    out = {}
    for trim_k in (TRIM_K, 1):
        kern = lambda tk=trim_k: krob.masked_trimmed_mean_cuda(rows, m, tk)  # noqa: E731
        plain = lambda tk=trim_k: krob.masked_trimmed_mean_torch(rows, m, tk)  # noqa: E731
        errs["masked_trimmed_mean"] = max(
            errs["masked_trimmed_mean"],
            _close(kern(), plain(), 1e-5, atol=1e-5, what=f"trimmed mean timed trim_k={trim_k}"))
        out[trim_k] = _timed(f"masked_trimmed_mean trim_k={trim_k}", kern, plain, None,
                             N_MAIN * P_MAIN * 4 + 4 * P_MAIN + 4 * N_MAIN,
                             (2 * _sorting_network_size(N_MAIN) + N_MAIN) * P_MAIN,
                             [N_MAIN, P_MAIN])
        names = _count_device_kernels(f"masked_trimmed_mean trim_k={trim_k}", kern,
                                      [N_MAIN, P_MAIN], calls=20, windows=5)
        _one_kernel_a_call("masked_trimmed_mean", names, "network_kernel", 20)
    network = (2 * _sorting_network_size(N_MAIN) + 2 * N_MAIN) * P_MAIN
    print(json.dumps({"phase": "kernels", "masked_trimmed_mean": "network_diagnostic",
                      "instructions": network,
                      "ms_at_fp32_issue_rate": network / F32_ISSUE_PER_S * 1e3,
                      "ms_at_half_rate": 2 * network / F32_ISSUE_PER_S * 1e3}), flush=True)
    del rows
    torch.cuda.empty_cache()
    return {"masked_trimmed_mean": out[TRIM_K]}


if __name__ == "__main__":
    main()
