"""``tools/dryrun_multichip.py`` at 2 gloo ranks on the CPU: every check
(data parallel step for step, FSDP pieces and bytes, TP + FSDP, GPipe,
ring attention, split DDIM sampling) within its bar."""

from infodiffusion_tpu_torch.tools.dryrun_multichip import dryrun_multichip


def test_dryrun_multichip_two_ranks(tmp_path):
    out = dryrun_multichip(2, steps=3, timeout=300, workdir=str(tmp_path))
    assert out["ranks"] == 2 and out["backend"] == "gloo"
    checks = out["checks"]
    assert {"dp losses, max diff over steps", "fsdp loss",
            "fsdp state bytes / dp", "tp+fsdp loss", "pp 1x2 forward",
            "pp 1x2 gradients", "sp ring forward", "sp ring gradients",
            "sharded ddim-4"} <= set(checks)
    assert all(ok for _, _, ok in checks.values()), checks
