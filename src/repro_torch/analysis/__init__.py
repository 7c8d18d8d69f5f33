"""Analysis of the port (port of ``repro/analysis``): analytic parameter
counts (:mod:`~repro_torch.analysis.params`) and the H100 roofline over a
cost count of torch's own (:mod:`~repro_torch.analysis.roofline`)."""
