"""PyTorch/CUDA port of ``imagecompression_adversarial_tpu`` (the JAX package
beside it stays the reference).

The port runs on an NVIDIA GPU: entry points default to ``device="cuda"``
and raise when no card is present unless the caller asks for
``device="cpu"``.  Activations are NCHW tensors in the ``channels_last``
memory format.  The one hand-written kernel is the fused GDN/IGDN forward
(``kernels/gdn.py``, ``csrc/gdn.cu``), built with ``nvcc`` on first use.
"""
