"""Cluster mode: embarrassingly-parallel per-timepoint jobs + merge.

Port of the reference's `pipeline/cluster.py` (SURVEY.md L7, section 2.2
`Toggle_Cluster_Options` / `Merge_Cluster_Jobs`): work splits into
independent per-timepoint jobs; each job loads the shared dataset
definition, processes its subset, and writes `job_tp<N>.xml`; a merge
step folds every job's ViewRegistrations and interest points back into
the master XML. Jobs are idempotent — a failed job is simply re-run
before merging. Host only: the device work is the job's `process_fn`.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence

from spim_registration_tpu_torch.core.dataset import Dataset
from spim_registration_tpu_torch.core.xml_io import load_dataset, save_dataset
from spim_registration_tpu_torch.utils.log import get_logger

logger = get_logger("cluster")


def job_xml_path(base_dir: str, tp: int) -> str:
    return os.path.join(base_dir, f"job_tp{tp}.xml")


def split_timepoints(dataset: Dataset) -> List[int]:
    """The job list: one job per timepoint (the reference's split unit)."""
    return dataset.timepoints()


def run_job(master_xml: str, tp: int, process_fn,
            out_xml: Optional[str] = None) -> str:
    """Run one per-timepoint job: load master, process tp, write job XML.

    `process_fn(dataset, tp)` mutates the dataset's views of that
    timepoint (detection results, registrations, ...).
    """
    ds = load_dataset(master_xml)
    process_fn(ds, tp)
    out = out_xml or job_xml_path(os.path.dirname(master_xml), tp)
    # keep only this tp's views so the merge is unambiguous
    ds_job = Dataset(base_path=ds.base_path)
    for (vtp, s), vd in ds.views.items():
        if vtp == tp:
            ds_job.add_view(vd)
    ds_job.bounding_boxes = ds.bounding_boxes
    save_dataset(ds_job, out)
    logger.info("job tp=%d -> %s", tp, out)
    return out


def merge_cluster_jobs(master_xml: str, job_xmls: Sequence[str],
                       out_xml: Optional[str] = None) -> Dataset:
    """Fold job XMLs back into the master dataset (Merge_Cluster_Jobs):
    each job view's transform chain replaces the master's, its interest
    points join the master's labels, and views the master lacks are
    added."""
    ds = load_dataset(master_xml)
    for jx in job_xmls:
        job = load_dataset(jx)
        for vid, vd in job.views.items():
            if vid in ds.views:
                ds.views[vid].transforms = vd.transforms
                ds.views[vid].interest_points.update(vd.interest_points)
            else:
                ds.add_view(vd)
        ds.bounding_boxes.update(job.bounding_boxes)
    save_dataset(ds, out_xml or master_xml)
    logger.info("merged %d jobs -> %s", len(job_xmls),
                out_xml or master_xml)
    return ds


def find_job_xmls(base_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(base_dir, "job_tp*.xml")))
