from pycusdr_tpu_torch.decode.frame_finder import Decoder
from pycusdr_tpu_torch.decode.rs import RSCodec

__all__ = ["Decoder", "RSCodec"]
