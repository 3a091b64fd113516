"""PyTorch/CUDA port of flow-timesnet-tpu for NVIDIA Hopper (H100).

This package stands beside the JAX package ``flow_timesnet_tpu`` and mirrors
its module names, so each module here has a counterpart of the same path
there. It imports nothing of the JAX package (nor pandas, PyYAML or
msgpack): what it needs of the framework-free host modules is copied.

The port serves the direct-mode forward (``Forecaster.forecast`` ->
``Engine.forward`` -> ``TimesNet.forward``), trains step by step or a
device-resident epoch at a time, on the live periods and on a frozen spec,
and trains from a YAML config and a long CSV (``train.py::train_once``,
``python -m flow_timesnet_tpu_torch.cli train``). The masked dilated-tap
fold convolution runs as hand-written CUDA kernels (``csrc/``): the forward,
its dh adjoint and its weight gradient. Entry points run on
``device="cuda"`` unless the caller asks for the CPU; on the CPU every
kernel wrapper takes its plain PyTorch version.
"""
