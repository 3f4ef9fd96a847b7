"""Networking layer — twin of beacon_node/lighthouse_network + network +
http_api + common/eth2 (gossip, req/resp, Beacon-API server/client)."""

from . import gossip, rpc, snappy, topics  # noqa: F401
from .api import BeaconApiClient, BeaconApiServer  # noqa: F401
