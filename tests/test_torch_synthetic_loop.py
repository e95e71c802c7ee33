"""Retrieval loop closure and the failure-path episode through the PyTorch
port's synthetic-oracle harness, on the CPU, in subprocesses (the oracle
patches the model entry points module-wide). The JAX package's bars
(``tests/test_synthetic_e2e.py:36-55, :82-106``):

- loop, 14 frames at 4 mm on the plane world: every frame tracked, at least
  one long loop edge with retrieval, none without, and the ATE with
  retrieval at most 1.05 x the ATE without;
- episode: one fnn frame, three loss frames, at least one relocalization
  attempt, one map reset, six frames tracked after it.
"""

from test_torch_synthetic_e2e import run_harness


def test_loop_closure_improves_ate(tmp_path):
    out = run_harness("--loop", "--frames", "14", "--noise", "0.004", "--out", str(tmp_path))
    on, off = out["loop"], out["no_retrieval"]
    assert on["frames_tracked_ok"] == 14 and off["frames_tracked_ok"] == 14
    assert on["n_long_loop_edges"] >= 1, out
    assert off["n_loop_edges"] == 0, out
    assert on["ate_rmse"] <= off["ate_rmse"] * 1.05, out


def test_failure_path_episode():
    out = run_harness("--episode", "--noise", "0")
    assert out["fnn_frames"] == 1
    assert out["loss_frames"] == 3
    assert out["reloc_attempts"] >= 1
    assert out["resets"] == 1
    assert out["post_reset_tracked"] == 6
