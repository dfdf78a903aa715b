"""Command-line interface — the headless execution surface.

Port of the reference's `cli.py`: every pipeline stage is a subcommand on
one dataset XML, loading it and saving it again around each stage (the
XML is the checkpoint).

    python -m spim_registration_tpu_torch.cli define     raw/
    python -m spim_registration_tpu_torch.cli simulate --out ds/ --views 4
    python -m spim_registration_tpu_torch.cli detect     ds/dataset.xml
    python -m spim_registration_tpu_torch.cli register   ds/dataset.xml
    python -m spim_registration_tpu_torch.cli define-bbox ds/dataset.xml roi --from-points beads
    python -m spim_registration_tpu_torch.cli fuse       ds/dataset.xml --out fused.npy
    python -m spim_registration_tpu_torch.cli deconvolve ds/dataset.xml --out psi.npy
    python -m spim_registration_tpu_torch.cli resave ds/dataset.xml --format zarr
    python -m spim_registration_tpu_torch.cli info       ds/dataset.xml

    python -m spim_registration_tpu_torch.cli tune       ds/dataset.xml
    python -m spim_registration_tpu_torch.cli icp-refine ds/dataset.xml

    python -m spim_registration_tpu_torch.cli cluster-job   ds/dataset.xml --tp 0
    python -m spim_registration_tpu_torch.cli cluster-merge ds/dataset.xml

`define` writes the XML of raw files (a `{tp}`/`{setup}` or
`{angle}/{channel}/{illum}/{tile}` pattern of `.npy` or TIFF, a CZI, a
MicroManager or a DHM export); `resave` rewrites the views as HDF5, zarr
or bdv.n5 pyramids, which later verbs then read. `fuse` and `deconvolve`
write `.npy`, `.zarr`, `.n5` or TIFF, or append the volume as a new view
setup of a BDV HDF5 (`--append-hdf5`); they take `--out-of-core`
(streaming fusion, blocked deconvolution over disk stores in
`--ooc-workdir`; `deconvolve` also `--block-z`). The compute verbs run on
the CUDA card; `--device cpu` runs them on the host (the counterpart of
the reference's JAX_PLATFORMS), and `--profile DIR` writes a
`torch.profiler` trace of the verb into DIR. `cluster-job` detects and
registers one timepoint into `job_tp<N>.xml`; `cluster-merge` (host only)
folds the job XMLs back into the master.
zarr, n5, CZI and `.npy` need nothing beyond numpy; TIFF, MicroManager and
DHM images need `imageio`, HDF5 needs `h5py`: without them those verbs
exit with code 2 and name the package.

`--mesh SPEC` (`auto`, `z=4`, `view=2,z=4`; `parallel.mesh_from_spec`)
runs a stage on a device mesh of `--device`'s kind: `detect` (DoG and
DoM, z-sharded per view), `register` (z-sharded detection, the matching
batch's pair axis over the mesh), `fuse` (the output box z-sharded),
`deconvolve` (psi z-sharded; a `view` axis runs the views data-parallel,
which needs the parallel scheme; with `--out-of-core` the z-blocks go
round the mesh) and `cluster-job`; `fuse --out-of-core` stays on one
device and says so, and `tune` / `icp-refine` accept the option and run
on one device, as in the reference. A mesh larger than the cards present
exits 2 ("mesh needs N devices, have M"). Nothing falls back to another
path.

`--multihost` (on every verb that takes `--mesh`) first joins the
processes named by COORDINATOR_ADDRESS (host:port), NUM_PROCESSES and
PROCESS_ID (`parallel.initialize_multihost`, torch.distributed) and
implies `--mesh auto`; the mesh then spans the processes. Every process
runs the verb on the same XML and computes; only process 0 prints the
results and writes the XML, manifests and volumes.

    COORDINATOR_ADDRESS=localhost:29500 NUM_PROCESSES=2 PROCESS_ID=0 \
        python -m spim_registration_tpu_torch.cli deconvolve ds/dataset.xml \
        --multihost --mesh z=8 --device cpu &
    COORDINATOR_ADDRESS=localhost:29500 NUM_PROCESSES=2 PROCESS_ID=1 \
        python -m spim_registration_tpu_torch.cli deconvolve ds/dataset.xml \
        --multihost --mesh z=8 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np

# verbs of the reference CLI that the port does not have yet
NOT_PORTED = ()


def _dataset_with_loader(xml_path: str):
    """The dataset of `xml_path` with the loader its base directory's
    files call for, in the reference's order: BDV HDF5 (`data.h5`), a
    zarr tree (a directory with `meta.json`), a bdv.n5 container, a CZI,
    MicroManager stacks, `.npy` volumes, else TIFF stacks."""
    from spim_registration_tpu_torch.core.imgloaders import (
        hdf5_loader,
        npy_loader,
        tiff_stack_loader,
    )
    from spim_registration_tpu_torch.core.xml_io import load_dataset

    ds = load_dataset(xml_path)
    base = ds.base_path
    files = sorted(os.listdir(base))
    h5 = os.path.join(base, "data.h5")
    zarrs = [f for f in files
             if os.path.exists(os.path.join(base, f, "meta.json"))]
    n5s = [f for f in files if f.endswith(".n5")
           and os.path.isdir(os.path.join(base, f))]
    czis = [f for f in files if f.endswith(".czi")]
    if os.path.exists(h5):
        ds.loader = hdf5_loader(h5)
    elif zarrs:
        from spim_registration_tpu_torch.core.zarr_store import zarr_loader

        ds.loader = zarr_loader(os.path.join(base, zarrs[0]))
    elif n5s:
        from spim_registration_tpu_torch.core.zarr_store import (
            n5_bdv_loader,
        )

        ds.loader = n5_bdv_loader(os.path.join(base, n5s[0]))
    elif czis:
        from spim_registration_tpu_torch.core.czi import czi_loader

        ds.loader = czi_loader(os.path.join(base, czis[0]))
    elif any("_MMStack_Pos" in f for f in files):
        from spim_registration_tpu_torch.core.micromanager import (
            micromanager_loader,
        )

        ds.loader = micromanager_loader(base)
    elif any(f.endswith(".npy") for f in files):
        ds.loader = npy_loader(base)
    else:
        ds.loader = tiff_stack_loader(base)
    return ds


def _mesh_from_args(args):
    """The stage's mesh from `--mesh` on `--device`'s kind (`auto` by
    default under `--multihost`), or None for the single-device
    engines."""
    from spim_registration_tpu_torch.parallel.mesh import mesh_from_spec

    spec = getattr(args, "mesh", None)
    if spec is None and getattr(args, "multihost", False):
        spec = "auto"
    return mesh_from_spec(spec, args.device)


def _is_primary() -> bool:
    """Only process 0 prints results and writes XML, manifests and
    volumes on a multi-process run (every process computes; outputs are
    gathered to all)."""
    from spim_registration_tpu_torch.parallel.multihost import (
        process_index,
    )

    return process_index() == 0


def _single_device_note(args, verb: str, why: str) -> None:
    if getattr(args, "mesh", None):
        print(f"note: {verb} {why}; --mesh does not apply",
              file=sys.stderr)


def _load_config(args):
    from spim_registration_tpu_torch.pipeline.config import (
        RunConfig,
        apply_overrides,
        from_json,
    )

    cfg = from_json(args.config) if getattr(args, "config", None) \
        else RunConfig()
    overrides: Dict[str, object] = {}
    for ov in getattr(args, "set", []) or []:
        key, _, val = ov.partition("=")
        try:
            overrides[key] = json.loads(val)
        except json.JSONDecodeError:
            overrides[key] = val
    return apply_overrides(cfg, overrides) if overrides else cfg


def _detect_format(base_path: str, fmt: str) -> str:
    if fmt != "auto":
        return fmt
    import glob

    if base_path.endswith(".czi") or glob.glob(
            os.path.join(base_path, "*.czi")):
        return "czi"
    if glob.glob(os.path.join(base_path, "*_MMStack_Pos*.tif*")):
        return "micromanager"
    return "pattern"


def cmd_define(args):
    """Write `dataset.xml` for raw files on disk (Define_Multi_View_Dataset):
    a filename pattern, a CZI, a MicroManager or a DHM export."""
    from spim_registration_tpu_torch.core.xml_io import save_dataset

    fmt = _detect_format(args.base_path, args.format)
    if fmt == "czi":
        import glob

        from spim_registration_tpu_torch.core.czi import define_dataset_czi

        path = args.base_path if args.base_path.endswith(".czi") \
            else sorted(glob.glob(os.path.join(args.base_path, "*.czi")))[0]
        ds = define_dataset_czi(path)
        base = os.path.dirname(os.path.abspath(path))
    elif fmt == "micromanager":
        from spim_registration_tpu_torch.core.micromanager import (
            define_dataset_micromanager,
        )

        ds = define_dataset_micromanager(args.base_path)
        base = args.base_path
    elif fmt == "dhm":
        from spim_registration_tpu_torch.core.dhm import define_dataset_dhm

        ds = define_dataset_dhm(args.base_path)
        base = args.base_path
    else:
        from spim_registration_tpu_torch.core.define import define_dataset

        ds = define_dataset(args.base_path, args.pattern,
                            voxel_size=tuple(args.voxel_size))
        base = args.base_path
    xml = os.path.join(base, "dataset.xml")
    save_dataset(ds, xml)
    print(f"defined {len(ds.views)} views "
          f"({len(ds.timepoints())} tp x {len(ds.setups())} setups) "
          f"-> {xml}")


def cmd_simulate(args):
    from spim_registration_tpu_torch.core.dataset import (
        Dataset,
        ViewDescription,
    )
    from spim_registration_tpu_torch.core.xml_io import save_dataset
    from spim_registration_tpu_torch.utils.simulation import (
        make_multiview_scene,
    )

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out, exist_ok=True)
    shape = tuple(args.shape)
    psf_sigmas = None
    if args.blur:
        psf_sigmas = [(2.5, 1.0, 1.0), (1.0, 1.0, 2.5), (2.0, 1.2, 1.2),
                      (1.2, 1.2, 2.0), (1.8, 1.0, 1.4), (1.4, 1.0, 1.8)]
    ds = Dataset(base_path=args.out)
    for tp in range(args.timepoints):
        scene = make_multiview_scene(
            rng, n_views=args.views, shape=shape, n_beads=args.beads,
            bead_sigma=args.bead_sigma, psf_sigmas=psf_sigmas)
        for s, vol in enumerate(scene.volumes):
            np.save(os.path.join(args.out, f"tp{tp}_setup{s}.npy"),
                    vol.astype(np.float32))
            ds.add_view(ViewDescription(view_id=(tp, s), angle=s,
                                        size=shape))
            np.save(os.path.join(args.out, f"truth_tp{tp}_setup{s}.npy"),
                    scene.models[s])
    xml = os.path.join(args.out, "dataset.xml")
    save_dataset(ds, xml)
    print(f"wrote {xml} ({args.timepoints} tp x {args.views} views)")


def cmd_detect(args):
    from spim_registration_tpu_torch.core.xml_io import save_dataset
    from spim_registration_tpu_torch.detect.dog import detect_beads_dataset
    from spim_registration_tpu_torch.utils.manifest import write_manifest
    from spim_registration_tpu_torch.utils.profiling import stage_timer

    ds = _dataset_with_loader(args.xml)
    cfg = _load_config(args)
    mesh = _mesh_from_args(args)
    with stage_timer("detect"):
        if args.method == "dom":
            from spim_registration_tpu_torch.detect.dom import detect_beads_dom
            from spim_registration_tpu_torch.parallel.sharded_detect import (
                sharded_detect_beads_dom,
            )

            pstr = (f"DoM r1={cfg.dom.radius1} r2={cfg.dom.radius2} "
                    f"t={cfg.dom.threshold}")
            for vid in sorted(ds.views):
                if mesh is not None:  # z-sharded DoM, never silently single
                    pts, resp = sharded_detect_beads_dom(
                        ds.get_image(vid), cfg.dom, mesh,
                        axis_name=mesh.axis_names[-1])
                else:
                    pts, resp = detect_beads_dom(ds.get_image(vid), cfg.dom,
                                                 device=args.device)
                ds.set_interest_points(vid, cfg.label, pts, resp,
                                       parameters=pstr)
        else:
            detect_beads_dataset(ds, label=cfg.label, params=cfg.detection,
                                 device=args.device, mesh=mesh)
    if not _is_primary():
        return
    save_dataset(ds, args.xml)
    counts = {}
    for vid in sorted(ds.views):
        ips = ds.views[vid].interest_points.get(cfg.label)
        counts[str(vid)] = 0 if ips is None else len(ips.points)
        print(f"view {vid}: {counts[str(vid)]} points")
    write_manifest(ds.base_path, "detect", cfg.detection,
                   {"points_per_view": counts})


def cmd_register(args):
    from spim_registration_tpu_torch.core.xml_io import save_dataset
    from spim_registration_tpu_torch.pipeline.run import (
        RegistrationConfig,
        register_views,
    )
    from spim_registration_tpu_torch.utils.manifest import write_manifest

    ds = _dataset_with_loader(args.xml)
    cfg = _load_config(args)
    rc = RegistrationConfig(detection=cfg.detection, pairwise=cfg.pairwise,
                            global_opt=cfg.global_opt)
    mesh = _mesh_from_args(args)
    for tp in ds.timepoints():
        views = ds.views_of_timepoint(tp)
        if args.channel is not None:
            # per-channel registration ("process channels separately")
            views = [v for v in views if v.channel == args.channel]
            if not views:
                print(f"tp {tp}: no views with channel {args.channel}",
                      file=sys.stderr)
                continue
        if all(cfg.label in v.interest_points for v in views):
            pts = [np.asarray(v.interest_points[cfg.label].points)
                   for v in views]
            res = register_views(None, rc, points=pts, device=args.device,
                                 mesh=mesh)
        else:
            vols = [ds.get_image(v.view_id) for v in views]
            res = register_views(vols, rc, device=args.device, mesh=mesh)
        for v, vd in enumerate(views):
            vd.set_transform("registration", res.models[v])
        if not _is_primary():
            continue
        print(f"tp {tp}: residual mean={res.mean_error:.4f} "
              f"max={res.max_error:.4f} px")
        write_manifest(ds.base_path, "register", rc, {
            "timepoint": tp,
            "mean_error_px": res.mean_error,
            "max_error_px": res.max_error,
            "pairs": {f"{i}-{j}": {
                "candidates": r.num_candidates,
                "inliers": r.num_inliers,
                "valid": r.valid,
                "mean_error_px": r.mean_error,
            } for (i, j), r in res.pair_results.items()},
            "timings_s": res.timings,
        })
    if _is_primary():
        save_dataset(ds, args.xml)


def _resolve_bbox(ds, args, vols, models):
    """Fusion ROI: a named bounding box stored in the XML (`--bbox NAME`)
    or the maximal box of the transformed view corners (default)."""
    from spim_registration_tpu_torch.fuse.bounding_box import (
        maximal_bounding_box,
    )

    name = args.bbox
    if name:
        if name not in ds.bounding_boxes:
            raise KeyError(
                f"bounding box {name!r} not in dataset (have: "
                f"{sorted(ds.bounding_boxes)})")
        return ds.bounding_boxes[name]
    return maximal_bounding_box([v.shape for v in vols], models)


def _export_volume(args, ds, out, tp, bbox, what):
    """Write a fused or deconvolved volume as `.npy`, a float32 zarr or n5
    volume (`.zarr` / `.n5`) or TIFF for any other suffix (`{tp}` in
    `--out` names the timepoint), or append it as a new view setup of an
    existing BDV HDF5 and save the XML (`--append-hdf5`, the reference's
    AppendSpimData2HDF5 export)."""
    from spim_registration_tpu_torch.core.imgloaders import save_tiff_stack

    if args.append_hdf5:
        from spim_registration_tpu_torch.core.resave import append_fused_hdf5

        vid = append_fused_hdf5(ds, args.append_hdf5, out, timepoint=tp,
                                bbox=bbox, xml_path=args.xml,
                                device=args.device)
        print(f"tp {tp}: {what} {out.shape} appended as setup "
              f"{vid[1]} -> {args.append_hdf5} (+{args.xml})")
        return
    n_tp = len(ds.timepoints())
    path = args.out.replace("{tp}", str(tp)) if "{tp}" in args.out \
        else (args.out if n_tp == 1 else f"tp{tp}_{args.out}")
    if path.endswith(".npy"):
        np.save(path, out)
    elif path.endswith(".zarr") or path.endswith(".n5"):
        from spim_registration_tpu_torch.core.zarr_store import create_volume

        driver = "zarr" if path.endswith(".zarr") else "n5"
        vol = create_volume(path, out.shape, dtype="float32",
                            driver=driver)
        vol.write(np.asarray(out, np.float32))
    else:
        save_tiff_stack(path, out)
    print(f"tp {tp}: {what} {out.shape} -> {path}")


def _require_h5py(args) -> None:
    """`--append-hdf5` needs h5py: check before any compute."""
    if args.append_hdf5:
        from spim_registration_tpu_torch.core.imgloaders import _optional

        _optional("h5py", "--append-hdf5", instead="--out")


def cmd_fuse(args):
    from spim_registration_tpu_torch.fuse.weighted_avg import TimelapseFusion

    _require_h5py(args)
    ds = _dataset_with_loader(args.xml)
    cfg = _load_config(args)
    mesh = _mesh_from_args(args)
    # one host array for every timepoint, written out before the next
    fuse = TimelapseFusion(cfg.fusion, args.device)
    for tp in ds.timepoints():
        views = ds.views_of_timepoint(tp)
        vols = [ds.get_image(v.view_id) for v in views]
        models = [v.model() for v in views]
        bbox = _resolve_bbox(ds, args, vols, models)
        if args.out_of_core:
            if mesh is not None:
                print("note: streaming fusion is disk-IO-bound and runs "
                      "single-device by design (fuse/streaming.py); "
                      "--mesh applies to the in-memory path only",
                      file=sys.stderr)
            out = _fuse_out_of_core(args, cfg, tp, vols, models, bbox)
        elif mesh is not None:
            from spim_registration_tpu_torch.parallel import (
                sharded_fuse_views,
            )

            out = sharded_fuse_views(vols, models, bbox, cfg.fusion,
                                     mesh=mesh,
                                     axis_name=mesh.axis_names[-1])
        else:
            out = fuse(vols, models, bbox)
        if _is_primary() and out is not None:
            _export_volume(args, ds, out, tp, bbox, "fused")


def _ooc_workdir(args, tp) -> str:
    return args.ooc_workdir or (str(args.out) + f".ooc_tp{tp}")


def _fuse_out_of_core(args, cfg, tp, vols, models, bbox):
    """Streaming fusion: the views staged into disk stores, fused block by
    block into a disk-resident output (`fuse/streaming.py`). Returns the
    fused array for export, or None when `--out` ends in .raw (the store
    is the output)."""
    from spim_registration_tpu_torch.fuse.streaming import (
        fuse_views_streaming,
    )
    from spim_registration_tpu_torch.native_blocks import RawVolumeStore

    workdir = _ooc_workdir(args, tp)
    os.makedirs(workdir, exist_ok=True)
    stores = []
    for i, v in enumerate(vols):
        st = RawVolumeStore(os.path.join(workdir, f"view{i}.raw"),
                            np.shape(v), create=True)
        st.write_block((0, 0, 0), np.asarray(v, np.float32))
        stores.append(st)
    raw_out = str(args.out).endswith(".raw")
    out_path = (str(args.out) if raw_out
                else os.path.join(workdir, "fused.raw"))
    out_store = RawVolumeStore(out_path, bbox.shape, create=True)
    fuse_views_streaming(stores, models, bbox, out_store, cfg.fusion,
                         device=args.device)
    print(f"tp {tp}: streaming fusion done (output at {out_path})",
          file=sys.stderr)
    return None if raw_out else out_store.read_block((0, 0, 0), bbox.shape)


def cmd_deconvolve(args):
    from spim_registration_tpu_torch.deconv import (
        extract_psf,
        prepare_views_for_deconvolution,
    )

    _require_h5py(args)
    ds = _dataset_with_loader(args.xml)
    cfg = _load_config(args)
    mesh = _mesh_from_args(args)
    for tp in ds.timepoints():
        views = ds.views_of_timepoint(tp)
        vols = [ds.get_image(v.view_id) for v in views]
        models = [v.model() for v in views]
        psfs = []
        for v, vol in zip(views, vols):
            ips = v.interest_points.get(cfg.label)
            if ips is None or len(ips.points) < 5:
                print(f"view {v.view_id}: no interest points; run detect "
                      "first", file=sys.stderr)
                return 1
            psf, _n = extract_psf(vol, v.model(), np.asarray(ips.points),
                                  device=args.device)
            psfs.append(psf)
        bbox = _resolve_bbox(ds, args, vols, models)
        if args.out_of_core:
            out = _deconvolve_out_of_core(args, cfg, tp, vols, models, psfs,
                                          bbox, mesh)
        else:
            prep = prepare_views_for_deconvolution(vols, models, psfs, bbox,
                                                   device=args.device)
            out = _deconvolve_in_memory(prep, cfg, args, mesh)
        if _is_primary() and out is not None:
            _export_volume(args, ds, out, tp, bbox, "deconvolved")


def _deconvolve_in_memory(prep, cfg, args, mesh):
    """RL on one device, or z-sharded over the mesh, where a "view" axis
    before the last runs the views data-parallel (the parallel update
    scheme)."""
    from spim_registration_tpu_torch.deconv import deconvolve

    if mesh is None:
        return deconvolve(prep, cfg.deconvolution, device=args.device)
    from spim_registration_tpu_torch.parallel import sharded_deconvolve

    view_axis = "view" if "view" in mesh.axis_names[:-1] else None
    return sharded_deconvolve(prep, cfg.deconvolution, mesh,
                              axis_name=mesh.axis_names[-1],
                              view_axis=view_axis)


def _deconvolve_out_of_core(args, cfg, tp, vols, models, psfs, bbox, mesh):
    """Out-of-core deconvolution: streamed prep (one source view resident
    at a time) -> the disk-resident `BlockedDeconvolutionRunner` (its
    z-blocks round the mesh when there is one). Returns the psi array for
    export, or None when `--out` ends in .raw (the psi store is the
    output; volumes beyond memory are never materialized)."""
    from spim_registration_tpu_torch.deconv.blocked import (
        BlockedDeconvolutionRunner,
    )
    from spim_registration_tpu_torch.deconv.prep_streamed import (
        prepare_views_streamed,
    )
    from spim_registration_tpu_torch.native_blocks import RawVolumeStore

    workdir = _ooc_workdir(args, tp)
    inputs = prepare_views_streamed(
        lambda v: np.asarray(vols[v]), models, psfs, bbox, workdir,
        device=args.device)
    raw_out = str(args.out).endswith(".raw")
    psi_path = (str(args.out) if raw_out
                else os.path.join(workdir, "psi.raw"))
    psi = RawVolumeStore(psi_path, bbox.shape, create=True)
    BlockedDeconvolutionRunner(inputs, psi, cfg.deconvolution,
                               block_z=args.block_z, device=args.device,
                               mesh=mesh).run()
    print(f"tp {tp}: out-of-core deconvolution done (psi at {psi_path})",
          file=sys.stderr)
    return None if raw_out else psi.read_block((0, 0, 0), bbox.shape)


def cmd_define_bbox(args):
    """Store a named bounding box in the XML: explicit --min/--max, or
    --from-points LABEL to box the transformed interest points plus
    --margin."""
    from spim_registration_tpu_torch.core.dataset import BoundingBox
    from spim_registration_tpu_torch.core.xml_io import save_dataset

    ds = _dataset_with_loader(args.xml)
    if args.from_points:
        from spim_registration_tpu_torch.fuse.bounding_box import (
            bounding_box_from_points,
        )

        pts = []
        for v in ds.views.values():
            ips = v.interest_points.get(args.from_points)
            if ips is None or not len(ips.points):
                continue
            A = v.model()
            pts.append(np.asarray(ips.points) @ A[:, :3].T + A[:, 3])
        if not pts:
            print(f"no interest points labeled {args.from_points!r}; "
                  "run detect first", file=sys.stderr)
            return 1
        bb = bounding_box_from_points(np.concatenate(pts),
                                      margin=args.margin, name=args.name)
    elif args.min is not None and args.max is not None:
        bb = BoundingBox(args.name, tuple(args.min), tuple(args.max))
    else:
        print("give --min Z Y X and --max Z Y X, or --from-points LABEL",
              file=sys.stderr)
        return 1
    ds.bounding_boxes[args.name] = bb
    save_dataset(ds, args.xml)
    print(f"bounding box {args.name!r}: min={bb.min} max={bb.max} "
          f"shape={bb.shape} -> {args.xml}")


def cmd_tune(args):
    """Headless InteractiveDoG analog: sweep sigma x threshold on one
    view, print the peak-count table and a suggested threshold."""
    from spim_registration_tpu_torch.detect.tune import (
        suggest_threshold,
        sweep_detection,
    )

    _single_device_note(args, "tune", "sweeps one view on one device")
    ds = _dataset_with_loader(args.xml)
    vid = tuple(args.view) if args.view else sorted(ds.views)[0]
    vol = ds.get_image(tuple(vid))
    table = sweep_detection(vol, device=args.device)
    sigmas = sorted({s for s, _ in table})
    thresholds = sorted({t for _, t in table})
    print("peaks per (sigma x threshold):")
    print("sigma\\thr " + " ".join(f"{t:>8g}" for t in thresholds))
    for s in sigmas:
        print(f"{s:>8g} " + " ".join(f"{table[(s, t)]:>8d}"
                                     for t in thresholds))
    sug = suggest_threshold(vol, sigma=args.sigma,
                            expected_points=args.expected_points,
                            device=args.device)
    print(f"suggested threshold (sigma={args.sigma}"
          + (f", ~{args.expected_points} points" if args.expected_points
             else "") + f"): {sug:.5f}")
    return 0


def cmd_icp_refine(args):
    """ICP refinement of already-registered views against view 0 of each
    timepoint (the reference's IterativeClosestPointPairwise after a
    descriptor registration). As in the reference, the stored "icp"
    transform is the ICP correction composed with the view's whole
    earlier model."""
    from spim_registration_tpu_torch.core.xml_io import save_dataset
    from spim_registration_tpu_torch.match.icp import (
        ICPParameters,
        icp_refine,
    )

    _single_device_note(args, "icp-refine", "runs on one device")
    ds = _dataset_with_loader(args.xml)
    cfg = _load_config(args)
    params = ICPParameters(max_distance=args.max_distance)
    for tp in ds.timepoints():
        views = ds.views_of_timepoint(tp)
        pts_world = []
        for v in views:
            ips = v.interest_points.get(cfg.label)
            if ips is None:
                print(f"view {v.view_id}: no interest points; run detect "
                      "first", file=sys.stderr)
                return 1
            A = v.model()
            pts_world.append(np.asarray(ips.points) @ A[:, :3].T + A[:, 3])
        for i, v in enumerate(views[1:], 1):
            M, matches, err, iters = icp_refine(
                pts_world[i], pts_world[0], params=params,
                device=args.device)
            M4 = np.vstack([M, [0, 0, 0, 1]])
            A4 = np.vstack([v.model(), [0, 0, 0, 1]])
            v.set_transform("icp", (M4 @ A4)[:3])
            print(f"tp {tp} view {v.view_id}: icp {len(matches)} matches, "
                  f"residual {err:.4f} px in {iters} iters")
    save_dataset(ds, args.xml)
    return 0


def cmd_cluster_job(args):
    """One per-timepoint cluster job: detect + register that timepoint,
    write job_tp<N>.xml (Toggle_Cluster_Options / per-job XML analog)."""
    from spim_registration_tpu_torch.detect.dog import detect_beads_dataset
    from spim_registration_tpu_torch.pipeline.cluster import run_job
    from spim_registration_tpu_torch.pipeline.run import (
        RegistrationConfig,
        register_views,
    )

    cfg = _load_config(args)
    stages = args.stages.split(",")
    mesh = _mesh_from_args(args)

    def process(ds, tp):
        ds.loader = _dataset_with_loader(args.xml).loader
        vids = [v.view_id for v in ds.views_of_timepoint(tp)]
        if "detect" in stages:
            detect_beads_dataset(ds, view_ids=vids, label=cfg.label,
                                 params=cfg.detection, device=args.device,
                                 mesh=mesh)
        if "register" in stages:
            views = ds.views_of_timepoint(tp)
            pts = [np.asarray(v.interest_points[cfg.label].points)
                   for v in views]
            rc = RegistrationConfig(detection=cfg.detection,
                                    pairwise=cfg.pairwise,
                                    global_opt=cfg.global_opt)
            res = register_views(None, rc, points=pts, device=args.device,
                                 mesh=mesh)
            for v, vd in enumerate(views):
                vd.set_transform("registration", res.models[v])
            print(f"tp {tp}: residual mean={res.mean_error:.4f} px")

    out = run_job(args.xml, args.tp, process, out_xml=args.out)
    print(f"job tp={args.tp} -> {out}")


def cmd_cluster_merge(args):
    from spim_registration_tpu_torch.pipeline.cluster import (
        find_job_xmls,
        merge_cluster_jobs,
    )

    jobs = args.jobs or find_job_xmls(os.path.dirname(
        os.path.abspath(args.xml)))
    if not jobs:
        print("no job XMLs found", file=sys.stderr)
        return 1
    merge_cluster_jobs(args.xml, jobs, out_xml=args.out)
    print(f"merged {len(jobs)} jobs into {args.out or args.xml}")


def cmd_resave(args):
    """Rewrite the views as HDF5, zarr or bdv.n5 pyramids (downsampled on
    `--device`) and save the XML; later verbs read the new container."""
    from spim_registration_tpu_torch.core.xml_io import save_dataset

    ds = _dataset_with_loader(args.xml)
    if args.format == "hdf5":
        from spim_registration_tpu_torch.core.resave import resave_hdf5

        out = args.out or args.h5 or os.path.join(ds.base_path, "data.h5")
        resave_hdf5(ds, out, max_levels=args.levels, device=args.device)
    elif args.format == "zarr":
        from spim_registration_tpu_torch.core.zarr_store import resave_zarr

        out = args.out or os.path.join(ds.base_path, "data.zarr")
        resave_zarr(ds, out, max_levels=args.levels, device=args.device)
    else:
        from spim_registration_tpu_torch.core.zarr_store import (
            resave_n5_bdv,
        )

        out = args.out or os.path.join(ds.base_path, "data.n5")
        resave_n5_bdv(ds, out, max_levels=args.levels, device=args.device)
    save_dataset(ds, args.xml)
    print(f"resaved to {out}")


def cmd_info(args):
    from spim_registration_tpu_torch.core.xml_io import load_dataset

    ds = _dataset_with_loader(args.xml) if args.load_images \
        else load_dataset(args.xml)
    print(f"dataset: {args.xml}")
    print(f"timepoints: {ds.timepoints()}")
    print(f"setups: {ds.setups()}")
    for vid, vd in sorted(ds.views.items()):
        labels = {k: len(v.points) for k, v in vd.interest_points.items()}
        print(f"  view {vid}: angle={vd.angle} size={vd.size} "
              f"transforms={[t.name for t in vd.transforms]} "
              f"points={labels}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spim-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", help="RunConfig JSON file")
        sp.add_argument("--set", action="append", metavar="KEY=VAL",
                        help="dotted config override, e.g. "
                             "detection.sigma=2.0")
        sp.add_argument("--device", default="cuda",
                        help="where the stage runs: cuda (default) or cpu")
        sp.add_argument("--profile", metavar="DIR",
                        help="write a torch.profiler trace of this stage "
                             "into DIR")
        sp.add_argument("--multihost", action="store_true",
                        help="join the processes named by "
                             "COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID "
                             "(torch.distributed) first; implies --mesh "
                             "auto")
        sp.add_argument("--mesh", metavar="SPEC",
                        help="run this stage on a device mesh of "
                             "--device's kind: 'auto' (every card, z "
                             "axis), 'z=4' or 'view=2,z=4'; default one "
                             "device (--multihost implies auto)")

    sp = sub.add_parser("define",
                        help="define a dataset from files on disk")
    sp.add_argument("base_path")
    sp.add_argument("--pattern", default="tp{tp}_setup{setup}.npy",
                    help="filename pattern with {tp} and {setup} or "
                         "{angle}/{channel}/{illum}/{tile} placeholders")
    sp.add_argument("--format", default="auto",
                    choices=["auto", "pattern", "czi", "micromanager",
                             "dhm"])
    sp.add_argument("--voxel-size", type=float, nargs=3,
                    default=[1.0, 1.0, 1.0], metavar=("Z", "Y", "X"))
    sp.set_defaults(fn=cmd_define)

    sp = sub.add_parser("simulate", help="generate a synthetic dataset")
    sp.add_argument("--out", required=True)
    sp.add_argument("--views", type=int, default=4)
    sp.add_argument("--timepoints", type=int, default=1)
    sp.add_argument("--beads", type=int, default=120)
    sp.add_argument("--shape", type=int, nargs=3, default=[96, 96, 96])
    sp.add_argument("--bead-sigma", type=float, default=1.7)
    sp.add_argument("--blur", action="store_true",
                    help="apply per-view anisotropic PSF blur")
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_simulate)

    sp = sub.add_parser("detect")
    sp.add_argument("xml")
    sp.add_argument("--method", default="dog", choices=("dog", "dom"),
                    help="DoG (default) or integral-image "
                         "Difference-of-Mean")
    common(sp)
    sp.set_defaults(fn=cmd_detect)

    sp = sub.add_parser("register")
    sp.add_argument("xml")
    sp.add_argument("--channel", type=int, default=None,
                    help="register only this channel "
                         "(default: all views together)")
    common(sp)
    sp.set_defaults(fn=cmd_register)

    sp = sub.add_parser("define-bbox", help="persist a named bounding "
                        "box (explicit or from detections)")
    sp.add_argument("xml")
    sp.add_argument("name")
    sp.add_argument("--min", type=int, nargs=3, metavar=("Z", "Y", "X"))
    sp.add_argument("--max", type=int, nargs=3, metavar=("Z", "Y", "X"))
    sp.add_argument("--from-points", metavar="LABEL",
                    help="box the transformed interest points with this "
                         "label")
    sp.add_argument("--margin", type=int, default=10)
    sp.set_defaults(fn=cmd_define_bbox)

    sp = sub.add_parser("tune", help="sweep DoG sigma/threshold on one "
                        "view (InteractiveDoG analog)")
    sp.add_argument("xml")
    sp.add_argument("--view", type=int, nargs=2, metavar=("TP", "SETUP"))
    sp.add_argument("--sigma", type=float, default=1.8)
    sp.add_argument("--expected-points", type=int, default=None)
    common(sp)
    sp.set_defaults(fn=cmd_tune)

    sp = sub.add_parser("icp-refine", help="ICP-refine registered views "
                        "against view 0 (per timepoint)")
    sp.add_argument("xml")
    sp.add_argument("--max-distance", type=float, default=5.0)
    common(sp)
    sp.set_defaults(fn=cmd_icp_refine)

    for name, fn, default in (("fuse", cmd_fuse, "fused.tif"),
                              ("deconvolve", cmd_deconvolve,
                               "deconvolved.tif")):
        sp = sub.add_parser(name)
        sp.add_argument("xml")
        sp.add_argument("--out", default=default,
                        help=".npy, .zarr, .n5, or TIFF for any other "
                             "suffix")
        sp.add_argument("--append-hdf5", metavar="H5",
                        help="append the output as a new view setup into "
                             "this existing BDV HDF5 (+XML update) "
                             "instead of writing --out")
        sp.add_argument("--bbox", metavar="NAME",
                        help="use this named bounding box from the XML "
                             "instead of the automatic maximal box")
        sp.add_argument("--out-of-core", action="store_true",
                        help="stream through disk-resident blocks "
                             "(larger-than-memory volumes; `--out x.raw` "
                             "keeps the result on disk only)")
        sp.add_argument("--ooc-workdir", metavar="DIR",
                        help="work directory for the out-of-core stores "
                             "(default: <out>.ooc_tp<N>)")
        if name == "deconvolve":
            sp.add_argument("--block-z", type=int,
                            help="out-of-core z-block height (default: "
                                 "auto)")
        common(sp)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("cluster-job",
                        help="run one per-timepoint job (detect+register)")
    sp.add_argument("xml")
    sp.add_argument("--tp", type=int, required=True)
    sp.add_argument("--stages", default="detect,register")
    sp.add_argument("--out", help="job XML path (default job_tp<N>.xml)")
    common(sp)
    sp.set_defaults(fn=cmd_cluster_job)

    sp = sub.add_parser("cluster-merge",
                        help="fold job XMLs back into the master XML")
    sp.add_argument("xml")
    sp.add_argument("jobs", nargs="*")
    sp.add_argument("--out")
    sp.set_defaults(fn=cmd_cluster_merge)

    sp = sub.add_parser("resave", help="rewrite the views as HDF5, zarr "
                        "or bdv.n5 pyramids")
    sp.add_argument("xml")
    sp.add_argument("--h5", help="HDF5 path (--format hdf5; default "
                                 "data.h5 beside the XML)")
    sp.add_argument("--out", help="output path (default data.h5, "
                                  "data.zarr or data.n5 beside the XML)")
    sp.add_argument("--format", default="hdf5",
                    choices=("hdf5", "zarr", "n5"))
    sp.add_argument("--levels", type=int, default=4)
    sp.add_argument("--device", default="cuda",
                    help="where the pyramids are downsampled: cuda "
                         "(default) or cpu")
    sp.set_defaults(fn=cmd_resave)

    sp = sub.add_parser("info")
    sp.add_argument("xml")
    sp.add_argument("--load-images", action="store_true")
    sp.set_defaults(fn=cmd_info)
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"error: the {argv[0]!r} verb is not ported yet "
              f"(see ROADMAP.md)", file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
    multihost = getattr(args, "multihost", False)
    if multihost:
        from spim_registration_tpu_torch.parallel.multihost import (
            initialize_multihost,
            shutdown_multihost,
        )

        initialize_multihost()
    try:
        if getattr(args, "profile", None):
            from spim_registration_tpu_torch.utils.profiling import trace

            with trace(args.profile):
                return args.fn(args) or 0
        return args.fn(args) or 0
    except (FileNotFoundError, KeyError, ValueError, ImportError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except BrokenPipeError:  # stdout closed early (e.g. piped to head)
        return 0
    finally:
        if multihost:  # every process leaves after process 0 has written
            shutdown_multihost()


if __name__ == "__main__":
    sys.exit(main())
