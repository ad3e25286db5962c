"""The benchmark of the PyTorch/CUDA port (``volsync_tpu_torch``): one
command runs one cell once (``python3 -m portbench.run``). Every piece is
found by name: configurations in ``configs/``, traffic mixes in
``traffic/``, the loads that mixes name in ``loads/``, per-layer
metric readers in ``metrics/``, kernel families in ``kernels/``. The
plain reference in ``reference/`` imports nothing of the port."""
