"""The system under test: the port's federation, built from a cell's files.

Everything the benchmark takes from the program is here: ``ModelConfig``,
``transformer.lm_loss`` as the learners' objective, ``optim.sgd``,
``core.Learner``, the protocol ``FederationEnv`` describes, ``Channel``
(the raw or int8 uplink, the int8 downlink through ``QuantCodec``) and
``Controller``, whose ``engine.run`` the window drives, as ``Driver.run``
drives it.  The learners' data closures hand out the benchmark's own token
batches; the initial model is the benchmark's draw.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from fedbench.harness.traffic import Shards

#: The configuration file's keys that are ``ModelConfig`` fields.
MODEL_KEYS = ("arch_type", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab_size", "vocab_pad_to", "tie_embeddings", "qkv_bias", "rope_theta",
              "n_experts", "expert_pad_to", "n_shared_experts", "shared_d_ff", "top_k",
              "moe_d_ff", "router_aux_coef")
JOURNAL_CAPACITY = 1 << 17


def model_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(name=config["name"], **{k: config[k] for k in MODEL_KEYS})


def learner_index(learner_id: str) -> int:
    """``learner_007`` -> 7."""
    return int(learner_id.rsplit("_", 1)[1])


class Federation:
    """A controller with its learners, its initial model set.

    ``weights`` maps each leaf name of ``harness/weights.layout`` to its
    tensor; the program's params tree is assembled from them by name after
    checking that the names and shapes are the program's own.
    """

    def __init__(self, config: dict, traffic: dict, shards: Shards,
                 weights: dict[str, torch.Tensor], device: torch.device):
        from repro_torch import optim
        from repro_torch.core import Controller, FederationEnv, Learner
        from repro_torch.core.transport import Channel
        from repro_torch.kernels.ops import QuantCodec
        from repro_torch.models import transformer
        from repro_torch.tree import flatten_with_path, unflatten

        cfg = model_config(config)
        named, structure = flatten_with_path(transformer.abstract_params(cfg))
        want = [(n, tuple(t.shape)) for n, t in named]
        have = [(n, tuple(t.shape)) for n, t in weights.items()]
        if want != have:
            raise ValueError(f"the program's params tree {want} is not the benchmark's {have}")
        tree = unflatten(structure, [weights[n] for n, _ in named])

        def loss_fn(params, batch):
            return transformer.lm_loss(params, batch, cfg)

        def eval_fn(params, batch):
            return {"eval_loss": loss_fn(params, batch)}

        self.learners = []
        for i in range(traffic["learners"]):
            self.learners.append(Learner(
                learner_id=f"learner_{i:03d}", loss_fn=loss_fn, eval_fn=eval_fn,
                data_fn=self._data_fn(shards, i), eval_data_fn=lambda i=i: shards.eval_batch(i),
                optimizer=optim.sgd(traffic["lr"]), num_examples=traffic["seqs_per_learner"],
                device=device))
        env = FederationEnv(protocol=traffic["protocol"], local_steps=traffic["local_steps"],
                            batch_size=traffic["batch_seqs"], learning_rate=traffic["lr"],
                            staleness_alpha=traffic.get("staleness_alpha", 0.5), device=device)
        channel = Channel(upload_codec=traffic["upload_codec"],
                          quantize_codec=QuantCodec() if traffic["downlink"] == "int8" else None,
                          device=device)
        self.controller = Controller(
            protocol=env.make_protocol(), channel=channel, arena_n_max=traffic["arena_rows"],
            arena_dtype=traffic["arena_dtype"], max_dispatch_workers=traffic["dispatch_workers"],
            journal_capacity=JOURNAL_CAPACITY, device=device)
        self.controller.set_initial_model(tree)
        del tree
        for learner in self.learners:
            self.controller.register_learner(learner)
        self.continuous = traffic["protocol"] != "sync"
        self.manifest = self.controller.manifest
        self.final_row: torch.Tensor | None = None

    @staticmethod
    def _data_fn(shards: Shards, i: int):
        calls = [0]

        def data_fn(batch_size: int) -> dict:
            if batch_size != shards.batch_seqs:
                raise ValueError(f"asked for {batch_size} sequences, the mix has {shards.batch_seqs}")
            batch = shards.batch(i, calls[0])
            calls[0] += 1
            return batch

        return data_fn

    @property
    def arena_width(self) -> int:
        """The arena's padded row: the length of every upload."""
        return int(self.controller.arena.padded_params)

    @property
    def leaf_sizes(self) -> list[int]:
        """Every leaf's element count, in the flat row's order."""
        return [s.size for s in self.manifest.specs]

    def leaf_change(self, row0: torch.Tensor) -> dict:
        """The norm of each leaf's change from the packed row ``row0`` to the
        committed global model."""
        now = self.controller.global_buffer
        return {s.name: float(torch.linalg.vector_norm(
                    now[s.offset: s.offset + s.size] - row0[s.offset: s.offset + s.size]))
                for s in self.manifest.specs}

    def record_steps(self, k: int, out: list) -> None:
        """Append to ``out`` each leaf's change after each of the next ``k``
        committed aggregates, read from outside the program by wrapping the
        controller's aggregate call, then unwrap it; the model committed by
        the ``k``-th is kept on the host as ``final_row``."""
        name = "aggregate_community" if self.continuous else "aggregate_round"
        inner = getattr(self.controller, name)
        row0 = self.controller.global_buffer

        def wrapped(*args: Any, **kwargs: Any):
            seconds = inner(*args, **kwargs)
            out.append(self.leaf_change(row0))
            if len(out) >= k:
                delattr(self.controller, name)
                self.final_row = self.controller.global_buffer.to("cpu", copy=True)
            return seconds

        setattr(self.controller, name, wrapped)

    def run_rounds(self, n: int) -> list:
        """``n`` rounds of a round-based protocol, one ``engine.run`` each."""
        return [self.controller.engine.run(rounds=1)[0] for _ in range(n)]

    def run_updates(self, n: int) -> list:
        """``engine.run(total_updates=n)``: ``n`` community updates and every
        one still in flight when the ``n``-th commits."""
        return self.controller.engine.run(total_updates=n)

    def uploads(self) -> list:
        """Every ``UploadArrived`` the engine has processed, in order."""
        from repro_torch.core.engine import UploadArrived

        return [e for e in self.controller.engine.event_log
                if isinstance(e, UploadArrived) and e.update is not None]

    def records(self) -> list[dict]:
        """The journal's in-memory records."""
        return self.controller.journal.records()

    def shutdown(self) -> None:
        """Stop the dispatch executor and drop the program's state."""
        self.controller.shutdown()
        self.controller = None
        self.learners = []


def async_schedule(records: list[dict], k: int) -> list[tuple[int, int, int]]:
    """``(learner, version, task)`` of the first ``k`` community updates'
    triggers, from the journal: the global version the trigger's task was
    dispatched with, and which of that learner's tasks it was."""
    tasks: dict[str, list[int]] = {}
    out = []
    for rec in records:
        if rec["kind"] == "dispatch":
            tasks.setdefault(rec["learner"], []).append(int(rec["model_version"]))
        elif rec["kind"] == "aggregate" and len(out) < k:
            lid = rec["trigger"]
            # The trigger's upload came from its newest task dispatched before
            # this aggregate (a learner has one task in flight at a time).
            out.append((learner_index(lid), tasks[lid][-1], len(tasks[lid]) - 1))
    return out


def p95(values: list[float]) -> float:
    """The 95th percentile by linear interpolation between order statistics
    (``statistics.quantiles(method="inclusive")``'s rule)."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = 0.95 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
