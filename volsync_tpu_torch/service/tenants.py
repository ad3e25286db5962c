"""Tenancy model for the mover-jax service plane.

Ports ``volsync_tpu/service/tenants.py`` whole.

A tenant is the unit of isolation the admission controller
(service/admission.py) and the deficit-round-robin scheduler
(service/scheduler.py) reason about: one operator namespace, one
customer, one CR group — whatever the deployment maps onto the
``x-volsync-tenant`` request-metadata key. Calls that present no tenant
fall into ``default``, so a single-tenant deployment behaves exactly
like the pre-tenancy server.

Tokens are tenant-scoped: a TenantConfig may carry its own bearer
token, in which case calls claiming that tenant must present it (the
shared service token no longer opens that tenant's door). Tenants
without a token of their own authenticate with the service token —
the envelope every deployment already has.

Quotas/weights per tenant:

- ``weight``       — deficit-round-robin share of device batch slots.
- ``max_streams``  — concurrent ChunkHash streams (None = controller
                     default, VOLSYNC_SVC_TENANT_STREAMS).
- ``max_queued``   — scheduler-queued segments; the credit pool behind
                     the per-stream backpressure pause (None =
                     VOLSYNC_SVC_TENANT_QUEUED).

``VOLSYNC_SVC_TENANTS`` configures all of it without code:
``gold:weight=4,streams=8,queued=64;bronze:weight=1``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Optional

from volsync_tpu_torch import envflags
from volsync_tpu_torch.analysis import lockcheck

#: Request-metadata key naming the calling tenant; absent -> "default".
TENANT_METADATA_KEY = "x-volsync-tenant"

DEFAULT_TENANT = "default"

#: Tenant names are metrics label values; cap their length and strip
#: anything outside a tame charset so hostile metadata cannot mint
#: unbounded or unprintable label values.
_MAX_NAME = 64
_SAFE = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def sanitize_tenant(raw: object) -> str:
    """Metadata value -> tenant name: printable-safe, bounded length,
    empty/absent -> DEFAULT_TENANT."""
    name = "".join(c for c in str(raw) if c in _SAFE)[:_MAX_NAME]
    return name or DEFAULT_TENANT


@dataclass(frozen=True)
class TenantConfig:
    """Per-tenant quota/weight/credential record."""

    name: str
    weight: int = 1
    max_streams: Optional[int] = None   # None -> controller default
    max_queued: Optional[int] = None    # None -> controller default
    token: Optional[str] = None         # None -> shared service token

    def __post_init__(self):
        if self.weight < 1:
            raise ValueError(f"tenant {self.name!r}: weight must be >= 1")


class TenantRegistry:
    """Known tenants + defaults for everyone else.

    The registry is OPEN: an unknown tenant name resolves to a config
    built from the defaults (weight 1, env-default quotas, service
    token). Registering a config pins that tenant's weight/quotas/token.
    """

    def __init__(self, configs: Iterable[TenantConfig] = ()):
        self._lock = lockcheck.make_lock("service.tenants")
        self._configs: dict[str, TenantConfig] = {}
        for cfg in configs:
            self.register(cfg)

    def register(self, cfg: TenantConfig) -> None:
        with self._lock:
            self._configs[cfg.name] = cfg

    def resolve(self, metadata: Mapping[str, object]) -> str:
        """Invocation-metadata mapping -> tenant name."""
        return sanitize_tenant(metadata.get(TENANT_METADATA_KEY, ""))

    def config(self, name: str) -> TenantConfig:
        with self._lock:
            cfg = self._configs.get(name)
        return cfg if cfg is not None else TenantConfig(name=name)

    def token_for(self, name: str) -> Optional[str]:
        """The tenant's own token, or None when it authenticates with
        the shared service token."""
        return self.config(name).token

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._configs)

    # -- spec parsing ------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: str) -> "TenantRegistry":
        """``name:key=value,...;name2:...`` with keys ``weight``,
        ``streams`` (max_streams), ``queued`` (max_queued), ``token``.
        Malformed entries raise ValueError — a typo'd quota spec must
        not silently admit a tenant on defaults."""
        configs = []
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            name, _, rest = entry.partition(":")
            name = sanitize_tenant(name)
            kwargs: dict = {}
            for pair in filter(None, (p.strip() for p in rest.split(","))):
                key, _, value = pair.partition("=")
                key = key.strip()
                value = value.strip()
                if key == "weight":
                    kwargs["weight"] = int(value)
                elif key == "streams":
                    kwargs["max_streams"] = max(1, int(value))
                elif key == "queued":
                    kwargs["max_queued"] = max(1, int(value))
                elif key == "token":
                    kwargs["token"] = value
                else:
                    raise ValueError(
                        f"unknown tenant spec field {key!r} in {entry!r}")
            configs.append(TenantConfig(name=name, **kwargs))
        return cls(configs)

    @classmethod
    def from_env(cls) -> "TenantRegistry":
        spec = envflags.svc_tenants_spec()
        return cls.from_spec(spec) if spec else cls()
