"""The dry run (``repro_torch.launch.dryrun``) of the pipelined train
cell: granite-8b ``train_4k`` on the (2, 16, 16) (pod, data, model) mesh
with ``--pipeline``, in a subprocess (its fake process group of 512 ranks
never enters the pytest process). Its stage's pipeline sends go in
``collective-permute``; FSDP2's gathers and reduce-scatters and tensor
parallelism's all-reduces are counted as on the single-pod cell
(``tests/test_torch_pipeline.py``), and the model FLOPs are the
reference's."""

from test_torch_pipeline import FIELDS, reference_dryrun, run_dryrun


def test_dryrun_of_the_pipelined_cell_on_two_pods(tmp_path):
    from repro.configs import get_config as rget
    from repro.models.config import SHAPES_BY_NAME as RSHAPES
    rc, out, recs = run_dryrun(tmp_path, "--arch", "granite-8b", "--shape",
                               "train_4k", "--mesh", "multi", "--pipeline")
    assert rc == 0, out
    assert "dry-run: 1 ok, 0 documented skips, 0 errors" in out
    rec = recs["granite-8b_train_4k_multi_pipeline"]
    assert set(FIELDS) <= set(rec)
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16"
    assert rec["chips"] == 512 and rec["pipelined"]
    assert rec["model_flops_total"] == reference_dryrun().model_flops(
        rget("granite-8b"), RSHAPES["train_4k"])
    coll, counts = rec["collective_bytes_per_device"], \
        rec["collective_counts"]
    assert coll["all-reduce"] > 0
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    # 8 microbatches of this data rank's 16 rows, 2 stages: 9 ticks, a
    # send at each of the first 8 forward and in the backward, of a
    # microbatch's (2, 4096, 4096) bfloat16 activations
    assert counts["collective-permute"] == 16
    assert coll["collective-permute"] == 16 * 2 * 4096 * 4096 * 2
