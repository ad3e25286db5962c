"""Device kernels of the port (ports ``volsync_tpu/ops/``): SHA-256
(``sha256``), content-defined chunking (``gearcdc``) and the fused
chunk+hash segment pipeline (``segment``). CUDA sources live in
``../csrc`` and are built by ``_build`` at first use."""
