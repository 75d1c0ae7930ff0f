"""Quickstart: synthetic chips -> train -> eval -> inference -> map -> export.

Runs entirely offline, on the card or on the CPU, in a couple of minutes:

    python -m instageo_tpu_torch.examples.quickstart /tmp/instageo_demo [--device cpu]

Mirrors the reference's notebook walkthroughs with the port's own pieces
end to end, through the run CLI (``train/run.py:main``) as the JAX
``examples/quickstart.py`` does; the serving artifact is ``torch.export``'s
(``predict.pt2``, the attention as the custom op
``instageo_tpu_torch::flash_attn_fwd``) where JAX writes StableHLO. The run
goes on ``--device`` (``cuda`` by default). ``quickstart_results.json``
beside the chips holds the wall seconds, each Hopper kernel's launches in
this process (``utils/telemetry.py:kernel_launches``, none on the CPU), the
test metrics and the artifact's path.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

# Runnable from anywhere without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def make_dataset(root: str, n: int = 16, size: int = 32) -> None:
    from instageo_tpu_torch.data.geotiff import Affine, write_geotiff
    from instageo_tpu_torch.data.table import write_csv

    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        arr = rng.integers(1, 10000, size=(6, size, size)).astype(np.uint16)
        sign = rng.choice([0, 1], size=(size // 16, size // 16))
        lab = np.repeat(np.repeat(sign, 16, 0), 16, 1).astype(np.int16)
        arr[0] = np.where(lab > 0, 8000, 1000)  # learnable signal in band 0
        tr = Affine.from_origin(499980 + i * 960, 4100040, 30, 30)
        write_geotiff(os.path.join(root, f"chip_{i}.tif"), arr, transform=tr,
                      crs=32633, nodata=0)
        write_geotiff(os.path.join(root, f"seg_map_{i}.tif"), lab[None],
                      transform=tr, crs=32633, nodata=-1)
        rows.append({"Input": f"chip_{i}.tif", "Label": f"seg_map_{i}.tif"})
    write_csv(os.path.join(root, "train.csv"), rows, ["Input", "Label"])


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("root", nargs="?", default="/tmp/instageo_demo")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (a card is required) or 'cpu'.")
    args = parser.parse_args(argv)
    root = args.root
    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    print(f"1/5 Writing a synthetic chip dataset to {root}")
    make_dataset(root)

    from instageo_tpu_torch.train.run import main as run_main
    from instageo_tpu_torch.utils.telemetry import kernel_launches

    common = [
        f"root_dir={root}", f"train_filepath={root}/train.csv",
        f"valid_filepath={root}/train.csv", f"test_filepath={root}/train.csv",
        f"run_dir={root}/run", f"device={args.device}",
        "model.model_name=prithvi_eo_tiny", "model.load_pretrained_weights=False",
        "dataloader.img_size=32", "dataloader.bands=[0,1,2,3,4,5]",
        "dataloader.mean=[5000,5000,5000,5000,5000,5000]",
        "dataloader.std=[3000,3000,3000,3000,3000,3000]",
        "dataloader.no_data_value=0", "train.ignore_index=-1",
        # decoded-chip cache: epochs 2-3 (and eval/inference below)
        # skip TIFF decode entirely
        f"dataloader.cache_dir={root}/chip_cache",
        "train.batch_size=8", "train.num_epochs=3", "train.learning_rate=0.002",
        "test.img_size=32", "test.crop_size=32", "test.stride=32",
    ]
    print("2/5 Training prithvi_eo_tiny for 3 epochs")
    history = run_main(["mode=train"] + common)
    ckpt = f"{root}/run/instageo_best_checkpoint"

    print("3/5 Evaluating + running chip inference")
    metrics = run_main(["mode=eval", f"checkpoint_path={ckpt}"] + common)
    print(f"    test accuracy: {metrics['test_Acc']:.3f}, "
          f"IoU: {metrics['test_IoU']:.3f}")
    run_main(["mode=chip_inference", f"checkpoint_path={ckpt}"] + common)

    print("4/5 Rendering the prediction map")
    from instageo_tpu_torch.apps.viz import create_map_with_geotiff_tiles

    preds = sorted(glob.glob(f"{root}/predictions/prediction_*.tif"))
    out = create_map_with_geotiff_tiles(preds, f"{root}/map.html",
                                        threshold=(0.5, 1.0))

    print("5/5 Exporting a deployable torch.export serving artifact")
    artifact = run_main(["mode=export", f"checkpoint_path={ckpt}",
                         f"export.path={root}/predict.pt2"] + common)
    print(f"    artifact: {artifact} "
          f"({os.path.getsize(artifact)} bytes, weights passed at call time, any batch)")
    launches = kernel_launches()
    results = {
        "device": args.device, "wall_s": time.perf_counter() - t0, "launches": launches,
        "train_step_losses": history.get("train_step_losses"),
        "test_metrics": {k: v for k, v in metrics.items() if isinstance(v, (int, float))},
        "predictions": len(preds), "artifact": artifact, "checkpoint": ckpt,
    }
    with open(os.path.join(root, "quickstart_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(f"    kernel launches: {json.dumps(launches)}")
    print(f"Done. Open {out} in a browser.")


if __name__ == "__main__":
    main()
