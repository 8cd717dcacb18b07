"""Stage ops of the port, one module per module of
``cl_multiview_stereo_tpu.ops``.  Plain PyTorch, except the depth-init cost
volume, whose CUDA kernel sits behind ``cost_volume.superpixel_cost_volume``."""
