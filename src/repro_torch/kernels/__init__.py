"""The port's kernel layer: hand-written Hopper kernels with plain twins.

``ops`` dispatches by device (kernel on CUDA, plain torch on the CPU);
``fedavg`` holds the masked FedAvg kernel's wrappers and plain versions;
``ref`` the oracles; ``_build`` compiles ``csrc/*.cu`` at first use.
"""
