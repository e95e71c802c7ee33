"""ATE CLI: Sim(3)-aligned trajectory error (the evo_ape replacement of the
eval scripts). Usage: python -m frodo_slam_tpu_torch.utils.ate <gt> <traj>."""

import sys

from .evaluate import ate_rmse

if __name__ == "__main__":
    gt, traj = sys.argv[1:3]
    print(f"ATE RMSE [m]: {ate_rmse(gt, traj):.6f}")
