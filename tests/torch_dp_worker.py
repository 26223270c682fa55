"""One process of the multi-process training checks of
tests/test_torch_train_dist.py (imports torch and knnsvc_torch only):

    python tests/torch_dp_worker.py RANK WORLD PORT JOB.pkl OUT.pkl

JOB.pkl holds {"h": HiFiGANConfig dict, "seed", "disc_width_scale",
"disc_periods", "disc_scales", "batch": the global numpy batch, "n_steps",
"train_h": HiFiGANConfig dict, "train": train()'s keyword arguments but
checkpoint_path, "checkpoint_paths": one per rank}. The process joins a
gloo group at 127.0.0.1:PORT through initialize_distributed; takes its
rank's contiguous part of the batch and runs n_steps of the one-device
train step from init_train_state(seed) on the CPU; then runs train() into
its rank's checkpoint path. As rank 0 it writes {"metrics": [...],
"trees": [G, MPD, MSD], "train_trees": [G]} to OUT.pkl."""

import pickle
import sys

import torch


def main(rank: int, world: int, port: int, job_path: str, out_path: str) -> None:
    from knnsvc_torch.config import HiFiGANConfig, ModelFamily
    from knnsvc_torch.io.jax_params import tree_from_module
    from knnsvc_torch.parallel.mesh import initialize_distributed
    from knnsvc_torch.train.loop import train
    from knnsvc_torch.train.trainer import init_train_state, make_train_step

    torch.set_num_threads(1)
    with open(job_path, "rb") as fh:
        job = pickle.load(fh)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        h = HiFiGANConfig.from_dict(job["h"])
        state = init_train_state(job["seed"], h, ModelFamily.MIX,
                                 disc_width_scale=job["disc_width_scale"],
                                 disc_periods=job["disc_periods"],
                                 disc_scales=job["disc_scales"], device="cpu")
        part = len(job["batch"]["audio"]) // world
        batch = {k: torch.from_numpy(v[rank * part:(rank + 1) * part])
                 for k, v in job["batch"].items()}
        step = make_train_step(h, ModelFamily.MIX)
        metrics = [{k: float(v) for k, v in step(state, batch).items()}
                   for _ in range(job["n_steps"])]
        trees = [tree_from_module(m) for m in (state.generator, state.mpd, state.msd)]
        trained = train(HiFiGANConfig.from_dict(job["train_h"]),
                        checkpoint_path=job["checkpoint_paths"][rank], **job["train"])
        if rank == 0:
            with open(out_path, "wb") as fh:
                pickle.dump({"metrics": metrics, "trees": trees,
                             "train_trees": [tree_from_module(trained.generator)]}, fh)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
