"""The port's kernel layer: hand-written Hopper kernels with plain twins.

``ops`` dispatches by device (kernel on CUDA, plain torch on the CPU) and
holds the downlink's ``QuantCodec``; ``fedavg`` (masked FedAvg),
``quantize`` (int8 quantize/dequantize and the wire layout), ``fused_agg``
(dequant-into-aggregate over the int8 arena) and ``robust`` (the masked
trimmed mean of the robust rules) hold the kernels' wrappers and plain
versions; ``ref`` the oracles; ``_build`` compiles ``csrc/*.cu`` at first use.
"""
