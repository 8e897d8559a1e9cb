"""The port's `launch/fft_dryrun.py` against the JAX package's plans.

The reference side runs once per module as a subprocess of this file
(``python test_torch_dryrun.py reference <out>``) with 512 forced host
devices, as the JAX package's dryrun runs: it plans every variant on the
256- and 512-device production meshes and reads each plan's cost model,
and never lowers or compiles. The port's records come from
`repro_torch.launch.fft_dryrun`, in this process, with no process group
and no card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MESH_NAMES = ("single_pod", "multi_pod")
# each variant's cost-model fields, read from the plan under these names
PLAN_FIELDS = {"plan_flops": "flops", "plan_hbm_bytes": "hbm_bytes",
               "plan_collective_bytes": "collective_bytes",
               "plan_exposed_collective_bytes": "exposed_collective_bytes"}
VARIANTS = ("segmented", "dist_base", "dist_fused", "dist_transposed",
            "pencil2d", "pencil3d", "dist_overlap4_analytic",
            "ooc_2^34_analytic")


def _reference(out: str) -> None:
    """The reference's plans for `repro.launch.fft_dryrun`'s variants at
    its defaults: the fields its records read from each plan."""
    import repro.fft as fft_api
    from repro.launch.mesh import make_production_mesh

    docs = {}
    for name in MESH_NAMES:
        mesh = make_production_mesh(multi_pod=name == "multi_pod")
        axes = tuple(mesh.shape.keys())
        d = int(mesh.devices.size)

        def fields(p):
            return {k: getattr(p, attr) for k, attr in PLAN_FIELDS.items()}

        recs = {"segmented": fields(fft_api.plan(
            kind="c2c", n=4096, batch_shape=(1 << 15,), mesh=mesh,
            placement="segmented", axes=axes))}
        for variant, kw in (
                ("dist_base", dict(natural_order=True, fuse_twiddle=False)),
                ("dist_fused", dict(natural_order=True, fuse_twiddle=True)),
                ("dist_transposed", dict(natural_order=False,
                                         fuse_twiddle=True))):
            recs[variant] = fields(fft_api.plan(
                kind="c2c", n=1 << 28, mesh=mesh, placement="distributed",
                axes=axes, overlap="off", **kw))
        recs["pencil2d"] = fields(fft_api.plan(
            kind="c2c", shape=(1 << 14, 1 << 14), mesh=mesh,
            placement="distributed", axes=axes, overlap="off"))
        p3 = fft_api.plan(kind="c2c", shape=(1 << 10, 1 << 10, 1 << 8),
                          mesh=mesh, placement="distributed", axes=axes[-2:],
                          overlap="off")
        recs["pencil3d"] = {
            **fields(p3), "n_exchanges": p3.dist.n_exchanges,
            "plan_per_leg_collective_bytes": list(
                p3.per_leg_collective_bytes)}
        p = fft_api.plan(kind="c2c", n=1 << 28, mesh=mesh,
                         placement="distributed", axes=axes,
                         natural_order=True, fuse_twiddle=True, overlap=4)
        recs["dist_overlap4_analytic"] = {
            "plan_collective_bytes": p.collective_bytes,
            "plan_exposed_collective_bytes": p.exposed_collective_bytes,
            "plan_hidden_collective_bytes": p.hidden_collective_bytes}
        recs["ooc_2^34_analytic"] = fft_api.factor_out_of_core(
            1 << 34, 1024 << 20).as_dict()
        docs[name] = {"devices": d, "variants": recs}
    Path(out).write_text(json.dumps(docs))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "ref.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, __file__, "reference", str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def port():
    from repro_torch.launch import fft_dryrun
    return {name: {r["name"]: r for r in fft_dryrun.main(["--mesh", name])}
            for name in MESH_NAMES}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_dryrun_plan_fields_equal_the_reference(reference, port, mesh,
                                                variant):
    want = reference[mesh]["variants"][variant]
    got = port[mesh][variant]
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_dryrun_records_every_reference_variant(reference, port, mesh):
    assert list(port[mesh]) == list(VARIANTS)
    for name, rec in port[mesh].items():
        if rec.get("analytic_only"):
            continue
        # one card's seconds; the segmented and 1-D/2-D plans split over
        # every rank, the 3-D pencil over the last two mesh dims
        want_d = (256 if name == "pencil3d"
                  else reference[mesh]["devices"])
        assert rec["devices"] == want_d
        assert rec["bound"] == max(
            ("compute_s", "memory_s", "collective_s"), key=rec.get)
        assert not {"flops", "bytes", "temp_bytes", "a2a_bytes"} & set(rec)


def test_dryrun_uses_the_h100s_rates_not_the_tpus():
    from repro_torch.launch import fft_dryrun
    # H100 SXM: 67 TFLOP/s f32 and 3.35 TB/s HBM3 (the H100 datasheet);
    # the network: one 400 Gb/s ConnectX-7 port a card (the DGX H100
    # datasheet), which equals the TPU's 50 GB/s ICI figure by coincidence
    assert (fft_dryrun.F32_FLOPS_S, fft_dryrun.HBM_BYTES_S,
            fft_dryrun.NET_BYTES_S) == (67e12, 3.35e12, 400e9 / 8)
    rec = fft_dryrun.record(fft_dryrun.fft_api.plan(
        kind="c2c", n=1 << 20, mesh=fft_dryrun.ShapeMesh((4,), ("data",)),
        placement="distributed"), "x")
    assert rec["compute_s"] == rec["plan_flops"] / 4 / 67e12
    assert rec["memory_s"] == rec["plan_hbm_bytes"] / 4 / 3.35e12
    assert rec["collective_s"] == rec["plan_collective_bytes"] / 4 / (
        400e9 / 8)


def test_dryrun_needs_no_process_group_and_touches_no_card(port):
    import torch
    import torch.distributed as dist
    assert not dist.is_initialized()
    assert not torch.cuda.is_initialized()


def test_dryrun_refuses_tune_and_names_the_reason(capsys):
    from repro_torch.launch import fft_dryrun
    with pytest.raises(SystemExit):
        fft_dryrun.main(["--tune"])
    assert "needs a process group" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        fft_dryrun.main(["--wisdom-path", "wisdom.json"])
    assert "unrecognized arguments" in capsys.readouterr().err


if __name__ == "__main__":
    # python test_torch_dryrun.py reference <out.json>
    _reference(sys.argv[2])
