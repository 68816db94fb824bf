"""Toy-sized copies of the benchmark's cells, for the host."""

from __future__ import annotations

from fedbench.harness import spec

#: Limits for the toy sizes, set from host readings of the toy cells (the
#: program on seeds 11, 12, 13 and 2**31 + 7, the control on seeds 1 and 2)
#: as the cells' own limits are set from the card's: above the program's
#: widest reading, below the control's where the toy size separates them.
#: At toy size the int8 cell's routing flips under bfloat16 and its control
#: does not separate; its faults do.
TOY_LIMITS = {
    "lm-sync-f32": {"train_loss_gap": 3e-4, "eval_loss_gap": 2e-4,
                    "step1_change_gap": 5e-3, "steps_change_gap": 5e-3},
    "moe-sync-int8": {"train_loss_gap": 0.05, "eval_loss_gap": 0.01,
                      "step1_change_gap": 0.1, "steps_change_gap": 1.0},
    "lm-async-f32": {"train_loss_gap": 2e-4, "step1_change_gap": 6e-3, "steps_change_gap": 5e-3},
}


#: Qwen1.5-MoE-A2.7B at 1 of its 24 layers, at its published widths
#: (https://huggingface.co/Qwen/Qwen1.5-MoE-A2.7B): the counts' worked
#: values and the toy int8 cell start from it.  The reference and the weights
#: layout cover this family, so a cell of it can be added by files alone.
QWEN2_MOE_L1 = {
    "name": "qwen2-moe-a2.7b-l1", "arch_type": "moe", "n_layers": 1, "d_model": 2048,
    "n_heads": 16, "n_kv_heads": 16, "head_dim": 128, "d_ff": 1408, "vocab_size": 151936,
    "vocab_pad_to": 256, "tie_embeddings": False, "qkv_bias": True, "rope_theta": 1000000.0,
    "n_experts": 60, "expert_pad_to": 64, "n_shared_experts": 4, "shared_d_ff": 5632,
    "top_k": 4, "moe_d_ff": 1408, "router_aux_coef": 0.001, "params": 1228025856,
}

#: A sync federation of that model on the int8 wire: int8 uplink into the
#: int8 arena, int8 downlink.  No cell of BENCHMARK.json runs it yet (see
#: PERF.md); the toy tests keep the reference's int8 and MoE paths honest.
INT8 = "moe-sync-int8"
INT8_TRAFFIC = {
    "protocol": "sync", "learners": 4, "dispatch_workers": 1, "arena_rows": 4,
    "local_steps": 8, "batch_seqs": 4, "seq_len": 1024, "seqs_per_learner": 128,
    "eval_seqs": 16, "lr": 0.003, "upload_codec": "int8", "arena_dtype": "int8",
    "downlink": "int8", "zipf_exponent": 1.0, "copy_prob": 0.3, "check_steps": 2,
    "trace_rounds": 2, "window_steps_per_s": 0.11,
}


def toy_cell(workload: str) -> spec.Cell:
    """``workload`` cut to a size the host runs in seconds: the same model
    family, protocol, codecs and arena, with tiny widths and few steps."""
    if workload == INT8:
        c = spec.Cell(name=workload, chips=1, config=dict(QWEN2_MOE_L1),
                      traffic=dict(INT8_TRAFFIC), limits={}, end_to_end=[], per_layer=[])
    else:
        c = spec.load_cell(workload)
    cfg = c.config
    cfg.update(n_layers=2, d_model=64, n_heads=4, head_dim=16, d_ff=128, vocab_size=500,
               vocab_pad_to=128, n_kv_heads=2 if cfg["n_kv_heads"] < cfg["n_heads"] else 4)
    if cfg["n_experts"]:
        cfg.update(n_layers=1, n_experts=6, expert_pad_to=8, top_k=2, moe_d_ff=32, shared_d_ff=64)
    c.traffic.update(seq_len=32, seqs_per_learner=16, batch_seqs=4, eval_seqs=8,
                     learners=min(c.traffic["learners"], 4), local_steps=2)
    if "warmup_updates" in c.traffic:
        c.traffic["warmup_updates"] = c.traffic["check_steps"] = 5
    c.limits = dict(TOY_LIMITS[workload])
    return c
