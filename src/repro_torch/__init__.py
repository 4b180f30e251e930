"""EPIM in PyTorch: the epitome operator, epitome-aware quantization and the
epitomized ResNet, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The layout mirrors the JAX package ``repro`` so each module has one
counterpart there:

core/     — EpitomeSpec and its index maps, the quantizer, the layers
kernels/  — the three epitome matmul kernels (CUDA C++ under csrc/), their
            plain PyTorch versions (ref.py) and the ops.py wrappers
models/   — ResNetModel (ResNet-50/101 and the reduced tiny-resnet)
pim/      — layer inventories and the kernel-exact spec designer
configs/  — named epitome variants and ``get_resnet``
convert   — parameters of the JAX model, as numpy, into this package

Entry points take ``device`` (default ``"cuda"``).  Tensors on the CPU run
every kernel's plain version; tensors on a CUDA device launch the kernel.
"""
