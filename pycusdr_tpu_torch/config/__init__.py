"""Config loading (``loader``) and the shipped JSON configs
(``configs/``, copies of ``pycusdr_tpu/config/configs/``)."""
