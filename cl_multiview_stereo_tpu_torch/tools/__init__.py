"""Command-line tools of the port, run as ``python -m
cl_multiview_stereo_tpu_torch.tools.<name>``."""
