"""PyTorch/CUDA port of the streaming FPGA-GPU ETL dataflow system.

Laid out in the same paths as the JAX package ``repro`` (the reference);
imports ``torch`` and ``numpy`` only.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""
