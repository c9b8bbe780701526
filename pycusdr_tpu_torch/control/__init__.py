"""Control plane: the XML-RPC management and monitoring server (``rpc``)
and the hamlib-compatible rig server and daemon that let gpredict steer
Doppler (``rig_server``, ``dummy_radios``, ``hamlib_daemon``)."""

from pycusdr_tpu_torch.control.dummy_radios import DummyRadio  # noqa: F401
from pycusdr_tpu_torch.control.rig_server import Rig_server  # noqa: F401
from pycusdr_tpu_torch.control.rpc import RpcInterface, dummyModulator  # noqa: F401
