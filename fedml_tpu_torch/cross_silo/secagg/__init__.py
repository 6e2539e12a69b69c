"""SecAgg cross-silo federation (port of ``fedml_tpu.cross_silo.secagg``)."""

from .sa_fedml_client_manager import SAClientManager
from .sa_fedml_server_manager import SAServerManager
from .sa_message_define import MyMessage

__all__ = ["SAClientManager", "SAServerManager", "MyMessage"]
