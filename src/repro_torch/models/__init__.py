"""Models of the port: the housing MLP and the transformer families.

Exports what is ported of the reference's ``repro.models``: ``ModelConfig``,
``plan_segments``, ``layers``, ``transformer``, ``kvcache`` and ``mlp``.
``sharding`` comes with slice G or H-5.
"""
from repro_torch.models.config import ModelConfig, plan_segments
from repro_torch.models import kvcache, layers, mlp, transformer

__all__ = ["ModelConfig", "plan_segments", "layers", "transformer", "kvcache", "mlp"]
