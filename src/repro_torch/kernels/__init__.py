"""The port's kernel layer: hand-written Hopper kernels with plain twins.

``ops`` dispatches by device (kernel on CUDA, plain torch on the CPU) and
holds the downlink's ``QuantCodec``; ``fedavg`` (masked FedAvg),
``quantize`` (int8 quantize/dequantize and the wire layout), ``fused_agg``
(dequant-into-aggregate over the int8 arena) and ``robust`` (the masked
trimmed mean of the robust rules) hold the kernels' wrappers and plain
versions; ``topk`` and ``sparse_agg`` the top-k uplink's selection and
scatter, torch ops on both devices as the reference's are XLA ops; ``ref``
the oracles; ``_build`` compiles ``csrc/*.cu`` at first use.
"""
