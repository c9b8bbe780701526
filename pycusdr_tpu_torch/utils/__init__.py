from pycusdr_tpu_torch.utils.filters import gaussian_filter, rrcosfilter

__all__ = ["gaussian_filter", "rrcosfilter"]
