"""The yardstick's arithmetic against the worked values of the benchmark's
definition, and the benchmark's parameter layout against the port's."""

from __future__ import annotations

import pytest

from fedbench.harness import counts, spec, weights
from fedbench.tests.toy import QWEN2_MOE_L1


def _config(name: str) -> dict:
    if name == QWEN2_MOE_L1["name"]:
        return dict(QWEN2_MOE_L1)
    return spec._load_json(spec.BENCH_DIR / "configs" / f"{name}.json")


def _near(x: float, want: float, rel: float) -> bool:
    return abs(x - want) <= rel * want


def test_fedlm_forward_flops_per_token():
    assert _near(counts.forward_flops_per_token(_config("fedlm-100m"), 1024), 1.6e8, 0.01)


def test_moe_useful_and_executed_flops_per_token():
    cfg = _config("qwen2-moe-a2.7b-l1")
    assert _near(counts.forward_flops_per_token(cfg, 1024), 8.0e8, 0.01)
    assert _near(counts.forward_flops_per_token(cfg, 1024, executed=True), 1.84e9, 0.01)


@pytest.mark.parametrize("nbytes, want_bytes, want_ms", [
    (counts.fedavg_f32_bytes(8, 73_937_920), 2.662e9, 0.795),
    (counts.fedavg_q8_bytes(4, 1_228_025_856), 9.90e9, 2.96),
    (counts.quantize_bytes(1_228_025_856, counts.quant_padded(1_228_025_856)), 6.16e9, 1.84),
])
def test_kernel_bytes_and_bounds(nbytes, want_bytes, want_ms):
    assert _near(nbytes, want_bytes, 0.001)
    assert _near(counts.bound_seconds(nbytes) * 1e3, want_ms, 0.003)


def test_quant_padding_follows_the_codecs():
    from repro_torch.kernels import quantize as q

    for n in (1, 255, 2048, 311_427_072, 73_937_920, 1_228_025_856):
        assert counts.quant_padded(n) == q.wire_layout(n)[0]
        assert counts.quant_padded(n, adaptive=False) == -(-n // (256 * 64)) * 256 * 64


def test_training_counts_three_forward_passes():
    cfg = _config("fedlm-100m")
    per = counts.forward_flops_per_token(cfg, 1024)
    assert counts.useful_flops(cfg, 1024, 10, 4) == pytest.approx(per * 34)


@pytest.mark.parametrize("name", ["fedlm-100m", "qwen2-moe-a2.7b-l1"])
def test_layout_is_the_ports_params_tree(name):
    from repro_torch.models import transformer
    from repro_torch.tree import flatten_with_path

    from fedbench.harness.system import model_config

    cfg = _config(name)
    named, _ = flatten_with_path(transformer.abstract_params(model_config(cfg)))
    assert [(n, tuple(t.shape)) for n, t in named] == [(n, s) for n, s, _ in weights.layout(cfg)]
    assert weights.param_count(cfg) == cfg["params"]
