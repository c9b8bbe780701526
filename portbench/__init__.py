"""The benchmark of pycusdr_tpu_torch (the PyTorch and CUDA port): one
program, ``run.py``, that runs one cell of ``BENCHMARK.json`` on the card and
prints its metrics, and the yardstick it holds the program to (traffic,
reference, work model, comparison), which later changes to the program
cannot touch."""
