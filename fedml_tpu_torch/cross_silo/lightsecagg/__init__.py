"""LightSecAgg cross-silo federation (port of
``fedml_tpu.cross_silo.lightsecagg``)."""

from .lsa_fedml_client_manager import LSAClientManager
from .lsa_fedml_server_manager import LSAServerManager
from .lsa_message_define import MyMessage

__all__ = ["LSAClientManager", "LSAServerManager", "MyMessage"]
