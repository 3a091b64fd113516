"""PyTorch/CUDA port of flow-timesnet-tpu for NVIDIA Hopper (H100).

This package stands beside the JAX package ``flow_timesnet_tpu`` and mirrors
its module names, so each module here has a counterpart of the same path
there. It imports nothing of the JAX package: what it needs of the
framework-free host modules is copied.

The port covers the direct-mode serving forward
(``Forecaster.forecast`` -> ``Engine.forward`` -> ``TimesNet.forward``) and
the training step on the live periods (``Engine.train_step``, with
``Engine.evaluate``). The masked dilated-tap fold convolution runs as
hand-written CUDA kernels: the forward (``csrc/tap_conv_fwd.cu``) and its
dh adjoint and weight gradient (``csrc/tap_conv_bwd.cu``). Entry points run on ``device="cuda"`` unless the
caller asks for the CPU; on the CPU every kernel wrapper takes its plain
PyTorch version.
"""
