"""Share (%) of the SHA-256 family's floor (``kernels/sha256.py``) in the
summed device time of its kernels, over the chunks hashed in the window."""

from portbench.run import roofline


def read(run):
    return roofline(run, "sha256", run.inputs.get("chunk_lengths"))
