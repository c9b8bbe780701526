"""The software front end: ``sim_frontend`` feeds a running modem the IQ a
GNU Radio flowgraph would (``python -m pycusdr_tpu_torch.frontend.sim_frontend``)."""
