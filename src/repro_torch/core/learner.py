"""The Federation Learner: local training/evaluation over a private shard.

The port of ``repro/core/learner.py``.  A learner receives a ``TrainTask``,
trains in the background (the round engine's executor provides the thread)
and reports completion with its trained model plus execution metadata; the
engine receives it as an ``UploadArrived`` event.  Evaluation is a
synchronous call.

The local step is ``torch.func.grad_and_value`` over the functional
``loss_fn(params, batch)`` — params are a plain tree of tensors, the same
shape as the reference's pytrees — followed by the optimizer's tree update.  On the top-k uplink the learner
ships the sparsified delta against the model it received and keeps an f32
error-feedback residual of everything it did not send.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import packing, tracing
from repro_torch.core.scheduler import TrainTask
from repro_torch.device import resolve_device, wait_queued
from repro_torch.kernels import topk as topk_kernels
from repro_torch.optim import Optimizer, apply_fedprox
from repro_torch.tree import tree_map

__all__ = ["LocalUpdate", "EvalReport", "Learner"]


@dataclasses.dataclass
class LocalUpdate:
    """Payload of MarkTaskCompleted (the engine's ``UploadArrived`` event).

    ``upload`` is the measured-wire fast path: the learner holds the
    manifest and a channel handle (shipped at registration), packs its
    trained params into the flat ``(P,)`` row padded to the arena width and
    sends it through ``Channel.upload``.  ``buffer`` is the pre-envelope
    flat-buffer path (manifest but no channel).  Both ``None`` means the
    controller must pack ``params`` itself.
    """

    learner_id: str
    round_id: int
    params: Any
    num_examples: int
    metrics: dict
    seconds_per_step: float
    buffer: Any = None
    upload: Any = None


@dataclasses.dataclass
class EvalReport:
    """Result of one synchronous EvaluateModel call on a learner."""

    learner_id: str
    round_id: int
    metrics: dict
    num_examples: int


class Learner:
    """A federation learner bound to a loss function and a private dataset.

    ``loss_fn(params, batch) -> scalar`` defines local training;
    ``eval_fn(params, batch) -> dict`` evaluation; ``data_fn(batch_size) ->
    batch`` and ``eval_data_fn()`` supply private data as tensors on
    ``device`` (the card unless ``device="cpu"``).
    """

    def __init__(
        self,
        learner_id: str,
        loss_fn: Callable[[Any, Any], torch.Tensor],
        eval_fn: Callable[[Any, Any], dict],
        data_fn: Callable[[int], Any],
        eval_data_fn: Callable[[], Any],
        optimizer: Optimizer,
        num_examples: int,
        device: str | torch.device | None = None,
    ):
        self.learner_id = learner_id
        self.device = resolve_device(device)
        self._loss_fn = loss_fn
        self._eval_fn = eval_fn
        self._data_fn = data_fn
        self._eval_data_fn = eval_data_fn
        self._optimizer = optimizer
        self.num_examples = num_examples
        self._step_cache: dict[float, Callable] = {}
        self.alive = True
        self._manifest = None
        self._upload_pad: int | None = None
        self._channel = None
        # Error-feedback residual of the sparse (topk) uplink: the f32
        # (padded_params,) carry of everything sparsification left behind,
        # on the learner's device.  None until the first sparse upload; rides
        # checkpoints via export_residual/restore_residual.
        self._residual: torch.Tensor | None = None

    # -- wire contract ------------------------------------------------------
    def accept_manifest(
        self, manifest: Any, pad_to: int | None = None, channel: Any = None
    ) -> None:
        """Receive the federation's wire contract (shipped once, at join).

        With a manifest the learner packs its own flat row, padded to
        ``pad_to`` (the arena row width); with a ``channel`` the row also
        crosses the measured uplink as an ``UploadEnvelope``.
        """
        self._manifest = manifest
        self._upload_pad = pad_to
        self._channel = channel

    # -- heartbeat ----------------------------------------------------------
    def ping(self) -> bool:
        """Heartbeat: True while the learner is alive (driver monitoring)."""
        return self.alive

    def shutdown(self) -> None:
        """Mark the learner dead (driver shutdown / failure injection)."""
        self.alive = False

    # -- training -----------------------------------------------------------
    def _build_step(self, loss_fn: Callable) -> Callable:
        opt = self._optimizer
        grad_and_value = torch.func.grad_and_value(loss_fn)

        def step(params, opt_state, batch):
            grads, loss = grad_and_value(params, batch)
            params, opt_state = opt.apply(params, grads, opt_state)
            return params, opt_state, loss

        return step

    def _make_step(self, prox_mu: float, global_params: Any) -> Callable:
        # The prox-free step is built once and cached across tasks, as in the
        # reference; the FedProx step closes over this task's global params.
        if prox_mu > 0.0:
            return self._build_step(apply_fedprox(self._loss_fn, prox_mu, global_params))
        step = self._step_cache.get(0.0)
        if step is None:
            step = self._step_cache[0.0] = self._build_step(self._loss_fn)
        return step

    def _topk_codec(self) -> Any | None:
        """The channel's topk upload codec, or None when the uplink is dense."""
        codec = getattr(self._channel, "upload_codec", None)
        return codec if getattr(codec, "codec_id", None) == "topk" else None

    def _upload_sparse(
        self, trained: torch.Tensor, base: torch.Tensor, codec: Any, task: TrainTask
    ) -> Any:
        """Error-feedback sparse uplink: accumulate, send top-k, carry the rest.

        ``acc = residual + (trained - base)`` is the full unsent update mass;
        the codec ships its ``k`` largest-magnitude coordinates and the
        residual keeps ``acc - sent``: exactly zero at sent coordinates for
        f32 values, the quantization error for int8 values (the subtraction
        uses the wire's values through ``unpack_coords``, so the carry sees
        what the controller sees).
        """
        acc = trained - base
        if self._residual is not None:
            acc = self._residual + acc
        upload = self._channel.upload(
            acc, metadata={"learner_id": self.learner_id, "round_id": task.round_id},
        )
        idx, val = codec.unpack_coords(upload.payload, int(acc.shape[0]), acc.device)
        self._residual = topk_kernels.ef_residual(acc, idx, val)
        telemetry = getattr(self._channel, "telemetry", None)
        if telemetry is not None:
            telemetry.gauge("learner.residual_norm").set(
                float(torch.linalg.vector_norm(self._residual)))
        return upload

    def export_residual(self) -> Any | None:
        """Host copy of the error-feedback residual (checkpoint save); None
        before the first sparse upload."""
        if self._residual is None:
            return None
        return self._residual.cpu().numpy()

    def restore_residual(self, buffer: Any | None) -> None:
        """Reload a checkpointed error-feedback residual onto the learner's device."""
        self._residual = (
            None if buffer is None
            else torch.as_tensor(buffer, dtype=torch.float32).to(self.device, copy=True)
        )

    def fit(self, params: Any, task: TrainTask) -> LocalUpdate:
        """Run ``task.local_steps`` local optimization steps (paper T2-T3)."""
        params = tree_map(lambda p: p.to(self.device), params)
        step = self._make_step(task.prox_mu, params)
        opt_state = self._optimizer.init(params)
        loss = torch.zeros((), device=self.device)
        topk_codec = self._topk_codec()
        base = None
        if topk_codec is not None and self._manifest is not None:
            # The sparse uplink ships deltas: snapshot the received model at
            # the wire width, so the update is against exactly what the
            # controller broadcast.
            base = packing.pack_numeric(params, pad_to=self._upload_pad)
        with tracing.Span("learner.steps", steps=task.local_steps) as steps:
            for _ in range(task.local_steps):
                batch = self._data_fn(task.batch_size)
                params, opt_state, loss = step(params, opt_state, batch)
            if steps.recording:
                # The host's enqueue time: the rest of the span is the wait.
                steps.fields["launch_s"] = steps.elapsed()
            # The card returns before it finishes: wait for this learner's
            # last step, so seconds_per_step (what task sizing consumes)
            # measures the training work, not its launch.  Learner threads
            # share the default stream, so the wait also covers work other
            # learners queued before that step (as the reference's
            # block_until_ready on one device), never work queued after it.
            wait_queued(self.device)
        buffer = upload = None
        if self._manifest is not None:
            with tracing.Span("learner.upload") as span:
                # Flat-buffer upload fast path: pack learner-side, padded to
                # the arena row width.
                buffer = packing.pack_numeric(params, pad_to=self._upload_pad)
                if self._channel is not None:
                    # Measured uplink: the row crosses the channel as a wire
                    # envelope; arrival reads exactly what the wire carried.
                    if base is not None:
                        upload = self._upload_sparse(buffer, base, topk_codec, task)
                    else:
                        upload = self._channel.upload(
                            buffer,
                            metadata={"learner_id": self.learner_id, "round_id": task.round_id},
                        )
                    span.fields["bytes"] = int(upload.payload.nbytes)
                    buffer = None
        return LocalUpdate(
            learner_id=self.learner_id,
            round_id=task.round_id,
            params=params,
            num_examples=self.num_examples,
            metrics={"train_loss": float(loss), "local_steps": task.local_steps},
            seconds_per_step=steps.seconds / max(task.local_steps, 1),
            buffer=buffer,
            upload=upload,
        )

    # -- evaluation ---------------------------------------------------------
    def evaluate(self, params: Any, round_id: int) -> EvalReport:
        """Synchronous EvaluateModel over the learner's private eval data."""
        params = tree_map(lambda p: p.to(self.device), params)
        batch = self._eval_data_fn()
        with torch.no_grad():
            metrics = {k: float(v) for k, v in self._eval_fn(params, batch).items()}
        return EvalReport(
            learner_id=self.learner_id,
            round_id=round_id,
            metrics=metrics,
            num_examples=self.num_examples,
        )
