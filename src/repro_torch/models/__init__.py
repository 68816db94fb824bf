"""Models of the port: the housing MLP and the transformer families.

Exports the reference's ``repro.models``: ``ModelConfig``, ``plan_segments``,
``layers``, ``transformer``, ``kvcache``, ``mlp`` and ``sharding`` (the
arena's layouts and the model axis: ``ShardingPolicy``, ``make_policy``,
``constrain``, ``seq_constrain``).
"""
from repro_torch.models.config import ModelConfig, plan_segments
from repro_torch.models import kvcache, layers, mlp, sharding, transformer

__all__ = ["ModelConfig", "plan_segments", "layers", "transformer", "kvcache", "mlp",
           "sharding"]
