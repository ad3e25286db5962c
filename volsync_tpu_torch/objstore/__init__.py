"""Object stores of the port (ports ``volsync_tpu/objstore/``): the
filesystem and in-memory stores (``store.py``), the fault-injection
wrapper (``faultstore.py``), the S3, Azure Blob and Swift clients
(``s3.py``, ``azure.py``, ``swift.py``; B2 and GCS go through the S3
client) and their in-process verifying fakes (``fakes3.py``,
``fakeazure.py``, ``fakeswift.py``)."""
