"""Device transport under the syncthing-local name (ports
``volsync_tpu/movers/syncthing/transport.py``): the DH device-identity
scheme is shared by the syncthing mesh AND the rsync mover's
asymmetric-key channel, so it lives at
volsync_tpu_torch/movers/devicetransport.py; this module re-exports
it."""

from volsync_tpu_torch.movers.devicetransport import (  # noqa: F401
    DH_G,
    DH_P,
    PlainFramed,
    accept_device,
    connect_device,
    device_id,
    device_id_from_private,
    generate_device_key,
    public_key,
)
