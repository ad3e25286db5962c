"""One module a kernel family, found by its name: ``KERNELS`` (substrings of the device kernels' names) and ``work(lengths)`` (operations and bytes the algorithm needs)."""
