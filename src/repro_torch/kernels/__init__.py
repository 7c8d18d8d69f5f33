"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``),
each with a plain PyTorch version (``ref.py``) and a wrapper (``ops.py``)
that launches the kernel on CUDA tensors and runs the plain version on CPU
tensors.  :mod:`repro_torch.kernels.build` compiles and loads them.  Each
wrapper declares its kernel's work to an active cost counter
(:func:`repro_torch.analysis.roofline.declares`), so a step counts the same
on either device."""
