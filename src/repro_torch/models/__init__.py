"""Models of the port: the housing MLP and the transformer families.

Exports the reference's ``repro.models``: ``ModelConfig``, ``plan_segments``,
``layers``, ``transformer``, ``kvcache``, ``mlp`` and ``sharding`` (of which
the arena's layouts are ported; the model axis is slice G-2).
"""
from repro_torch.models.config import ModelConfig, plan_segments
from repro_torch.models import kvcache, layers, mlp, sharding, transformer

__all__ = ["ModelConfig", "plan_segments", "layers", "transformer", "kvcache", "mlp",
           "sharding"]
