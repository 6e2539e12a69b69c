#!/usr/bin/env python3
"""One participant of a cross-silo federation of the port, as
``CrossSiloLauncher`` starts it (``fedml_tpu_torch/cross_silo/client/
client_launcher.py``): its rank, role and run id come from
``FEDML_TPU_RANK``, ``FEDML_TPU_ROLE`` and ``FEDML_TPU_RUN_ID``, the run's
arguments from ``XS_CFG`` (a JSON object of ``Arguments`` fields: dataset,
model, ``backend``, ``client_id_list``, ``mqtt_config``, ``store_dir`` or
``filestore_dir``, ...).  The server calls ``run_cross_silo_server`` and,
when ``XS_OUT`` names a file, saves the final global params there
(``torch.save`` of the ``{name: tensor}`` dict, on the CPU); a client calls
``run_cross_silo_client``.  Runs on the card unless ``XS_CFG`` sets
``"device": "cpu"``.

    from fedml_tpu_torch.cross_silo.client.client_launcher import \\
        CrossSiloLauncher
    CrossSiloLauncher("tools/torch_cross_silo_entry.py", run_id="r1",
                      client_ranks=[1, 2],
                      extra_env={"XS_CFG": json.dumps(cfg),
                                 "XS_OUT": "server_params.pt"}).run()
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import fedml_tpu_torch  # noqa: E402
from fedml_tpu_torch.cross_silo.client.client_launcher import (  # noqa: E402
    env_rank, env_role, env_run_id)


def main():
    cfg = json.loads(os.environ["XS_CFG"])
    args = fedml_tpu_torch.load_arguments().update(**cfg)
    args.update(training_type="cross_silo", rank=env_rank(),
                run_id=env_run_id())
    if env_role() == "server":
        params = fedml_tpu_torch.run_cross_silo_server(args)
        out = os.environ.get("XS_OUT")
        if out:
            torch.save({k: v.detach().cpu() for k, v in params.items()}, out)
    else:
        fedml_tpu_torch.run_cross_silo_client(args)


if __name__ == "__main__":
    main()
