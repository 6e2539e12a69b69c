#!/usr/bin/env python3
"""Where the int8 wire's loss gap on the text model comes from
(``chip_smoke.py`` phase 20's text federation): the multi-rank two-tier
run at each wire precision (fp32; int8 with and without ``wire_overlap``;
int8 at ``wire_block`` 64; bf16), the in-process ``HierarchicalSiloAPI``
off and at int8 (which quantizes the silos' partials only, not the state
sync), and, in each multi-rank run at int8, every state sync's error as
the silos receive it beside the link's residual step
(``chip_smoke.WireStateSyncs``).  Prints each run's per-round losses and
writes ``chiprun_out/wire_int8_gap.json``.

    python3 tools/torch_wire_int8_gap.py
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RUNS = (("fp32", dict(wire_precision="fp32")),
        ("int8", dict(wire_precision="int8")),
        ("int8_overlap", dict(wire_precision="int8", wire_overlap=True)),
        ("int8_block64", dict(wire_precision="int8", wire_block=64)),
        ("bf16", dict(wire_precision="bf16")))


def main():
    import torch

    import chip_smoke as cs
    import fedml_tpu_torch
    from fedml_tpu_torch import data, model
    from fedml_tpu_torch.core import wire
    from fedml_tpu_torch.ops import cuda_build
    from fedml_tpu_torch.store.hierarchy import (HierarchicalSiloAPI,
                                                 run_silo_federation)

    if not torch.cuda.is_available():
        sys.exit("this needs a CUDA device")
    dev = "cuda"
    smi = cs.nvidia_smi()
    cuda_build.build()
    args = cs.sp_args(fedml_tpu_torch, **cs.WIRE_TEXT)
    ds, n_out = data.load(args)
    out = {"card": smi, "runs": {}}

    for tag, over in RUNS:
        t0 = time.time()
        built, hist = {}, {}
        for r in (2, 1, 0):
            a = cs.sp_args(fedml_tpu_torch, **dict(
                cs.WIRE_TEXT, rank=r, run_id=f"gap_{tag}",
                **dict(cs.WIRE_DIST, **over)))
            m = model.create(a, n_out)
            built[r] = (a, m, HierarchicalSiloAPI(a, dev, ds, m))

        def run(r):
            a, m, api = built[r]
            hist[r] = run_silo_federation(a, dev, ds, m, api=api)

        with cs.WireStateSyncs(wire) as syncs:
            cs.wire_threads(torch, (2, 1, 0), f"gap_{tag}", run)
        losses = [h["train_loss"] for h in hist[0]]
        rows = syncs.check() if over["wire_precision"] == "int8" else []
        out["runs"][tag] = {"losses": losses, "state_syncs": rows,
                            "seconds": time.time() - t0}
        print(f"{tag}: losses {losses}; state syncs {rows} [{smi}]",
              flush=True)

    for tag, over in (("inprocess_off", {}),
                      ("inprocess_int8", dict(wire_precision="int8"))):
        a = cs.sp_args(fedml_tpu_torch, **dict(cs.WIRE_TEXT, **over))
        api = HierarchicalSiloAPI(a, dev, ds, model.create(a, n_out))
        losses = [float(api.train_one_round(r)["train_loss"])
                  for r in range(cs.WIRE_TEXT["comm_round"])]
        out["runs"][tag] = {"losses": losses}
        print(f"{tag}: losses {losses} [{smi}]", flush=True)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "wire_int8_gap.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
