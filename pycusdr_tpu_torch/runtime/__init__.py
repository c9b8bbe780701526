"""The process pipeline: the orchestrator (``PyCuSDR``), one
demodulator child per Rx radio or one lockstep channel-group child, the
decoder child, the sample ingest (``sigfifo``) and the in-flight dispatch
queue (``pipeline``); ``cli`` is ``python -m pycusdr_tpu_torch``."""
