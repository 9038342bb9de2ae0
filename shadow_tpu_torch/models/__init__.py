"""Application models of the CPU engine (the port's copy of the
reference package's models/, cut to the models with a device twin:
PHOLD, tgen and Tor). A process path "model:<name>" selects one; the
device engine runs their vectorized twins (device/apps.py) instead.
`model:tgen_tcp_*` needs the socket stack and is refused by
core/build.py.
"""

from __future__ import annotations

from shadow_tpu_torch.models.base import ModelApp, parse_kv_args
from shadow_tpu_torch.models.phold import PholdApp
from shadow_tpu_torch.models.tgen import TgenClientApp, TgenServerApp
from shadow_tpu_torch.models.tor import TorClientApp, TorRelayApp

_REGISTRY = {
    "phold": PholdApp,
    "tgen_client": TgenClientApp,
    "tgen_server": TgenServerApp,
    "tor_relay": TorRelayApp,
    "tor_client": TorClientApp,
}


def is_model_path(path: str) -> bool:
    return path.startswith("model:")


def make_app(path: str, args, host_id: int, n_hosts: int) -> ModelApp:
    if not is_model_path(path):
        raise ValueError(f"process path {path!r} is not a model")
    name = path[len("model:"):]
    if name not in _REGISTRY:
        raise ValueError(f"unknown model app {name!r} "
                         f"(have: {sorted(_REGISTRY)})")
    return _REGISTRY[name](parse_kv_args(args), host_id, n_hosts)


__all__ = ["ModelApp", "make_app", "is_model_path", "parse_kv_args",
           "PholdApp", "TgenClientApp", "TgenServerApp", "TorRelayApp",
           "TorClientApp"]
