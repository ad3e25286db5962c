"""The port's part of the reference's ``volsync_tpu/analysis/``: the
lock-order and race detector (``lockcheck``) that the repository, the
stores, the batcher and the service build their locks through."""
