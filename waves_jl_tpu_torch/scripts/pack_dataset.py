"""Pack a dataset's per-episode files into one native shard (the port of
`scripts_tpu/pack_dataset.py`; `native/dataset_shard.cpp`):

    python -m waves_jl_tpu_torch.scripts.pack_dataset --data data/run1 \\
        [--out data/run1/data.wshard]

Reads `episodes/episode<i>.npz` and `.wbin` under `--data` in episode
order, each onto the host, and appends it to the shard, so the packer's
memory stays one episode's whatever the dataset's size. Runs on the host
only; either package reads the shard.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import time

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from waves_jl_tpu_torch.data import load_episode, open_episodes_shard


def episode_paths(data: str) -> list[str]:
    """The dataset's episode files, ordered by their episode number."""
    paths = (glob.glob(os.path.join(data, "episodes", "episode*.npz"))
             + glob.glob(os.path.join(data, "episodes", "episode*.wbin")))
    return sorted(paths, key=lambda q: int("".join(c for c in os.path.basename(q) if c.isdigit())))


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True)
    p.add_argument("--out", default=None, help="shard path (default <data>/data.wshard)")
    args = p.parse_args(argv)
    out = args.out or os.path.join(args.data, "data.wshard")
    paths = episode_paths(args.data)
    if not paths:
        sys.exit(f"no episodes under {args.data}")
    t0 = time.time()
    shard = open_episodes_shard(out)
    for i, path in enumerate(paths):
        shard.append(load_episode(path, device=None))
        if (i + 1) % 100 == 0:
            print(f"packed {i + 1}/{len(paths)}", flush=True)
    shard.finish()
    print(f"packed {len(paths)} episodes -> {out} ({os.path.getsize(out) / 1e9:.2f} GB) "
          f"in {time.time() - t0:.1f}s", flush=True)
    return out


if __name__ == "__main__":
    main()
