"""tools_torch/mosaic_distributed.py's dryrun on the CPU, as
tests/test_distributed.py runs the JAX tool's: two processes in a gloo
group (``file://`` init under the test's directory), each ingesting its
own fields and running its own 2-slot mesh, only the count vectors
exchanged; their count tables match a single-process run of the same
fields.  The subprocess has an explicit timeout."""

import json
import os
import subprocess
import sys


def test_mosaic_distributed_dryrun(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tool = os.path.join(repo, "tools_torch", "mosaic_distributed.py")
    out = subprocess.run(
        [sys.executable, tool, "--dryrun", "--device", "cpu", "--workdir",
         str(tmp_path), "--timeout", "240"],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    report = json.loads(out.stdout[out.stdout.index("{"):])
    assert report["counts_match_single_process"] is True
    assert report["counts_equal_single_process"] is True
    assert len(report["per_host"]) == 2
    for host in report["per_host"]:
        assert host["ingest_s"] >= 0 and host["compute_s"] > 0
