"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``),
each with a plain PyTorch version (``ref.py``) and a wrapper (``ops.py``)
that launches the kernel on CUDA tensors and runs the plain version on CPU
tensors.  :mod:`repro_torch.kernels.build` compiles and loads them."""
