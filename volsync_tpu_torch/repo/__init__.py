"""Repository-format helpers of the port (ports ``volsync_tpu/repo/``;
this slice carries only ``blobid``)."""
