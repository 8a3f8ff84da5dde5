"""Run chosen phases of `chip_smoke.py` alone on the card.

A phase here is one of `chip_smoke.py`'s path functions that takes
(dev, asset_dir, smi_line): `partcrafter_path`, `craftsman_path`,
`triposg_path`, `flexicubes_path`, `crm_path`, `hunyuan3d_shape_path`, ...
Each runs as `chip_smoke.main` runs it (TF32 off, the workflow inputs
written first), without the kernel builds and the other phases, so a
changed path is checked in a short call before the whole script:

    python3 chip_phases.py partcrafter_path craftsman_path \
        --out chiprun_out/phases.json

It prints the card's `nvidia-smi` name and power limit, each phase's
seconds, and exits 1 when the card is absent or a phase raised.
"""

import argparse
import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))


def main(names, out_path=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as C
    from comfy3d_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi_line = C.smi("name,power.limit")
    print(smi_line, flush=True)
    asset_dir = os.path.join(_build.BUILD_DIR, "chip_smoke")
    os.makedirs(asset_dir, exist_ok=True)
    C.workflow_files(asset_dir, asset_dir)
    out, ok = {"nvidia_smi": smi_line}, True
    for name in names:
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                rec = getattr(C, name)(dev, asset_dir, smi_line)
        except Exception as e:
            traceback.print_exc()
            rec, ok = {"error": repr(e)}, False
        rec["s"] = time.perf_counter() - t0
        out[name] = rec
        print(f"{name}: {rec['s']:.1f} s", flush=True)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+",
                    help="chip_smoke path functions, e.g. craftsman_path")
    ap.add_argument("--out", help="write the phases' records (JSON) here")
    args = ap.parse_args()
    sys.exit(main(args.phases, args.out))
