"""PyTorch/CUDA port of the MAB-scheduled asynchronous FL system.

Twin of the JAX package ``repro`` (same module layout and names), running
on an NVIDIA H100 through hand-written CUDA kernels (``kernels/csrc``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
see ``repro_torch.device``.
"""
