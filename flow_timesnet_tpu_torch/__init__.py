"""PyTorch/CUDA port of flow-timesnet-tpu for NVIDIA Hopper (H100).

This package stands beside the JAX package ``flow_timesnet_tpu`` and mirrors
its module names, so each module here has a counterpart of the same path
there. It imports nothing of the JAX package: what it needs of the
framework-free host modules is copied.

The port covers the direct-mode serving forward so far:
``Forecaster.forecast`` -> ``Engine.forward`` -> ``TimesNet.forward``, whose
masked dilated-tap fold convolution runs as a hand-written CUDA kernel
(``csrc/tap_conv_fwd.cu``). Entry points run on ``device="cuda"`` unless the
caller asks for the CPU; on the CPU every kernel wrapper takes its plain
PyTorch version.
"""
