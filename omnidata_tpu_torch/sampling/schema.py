"""point_info persistence: the reference's filename grammar and JSON layout
(point_info/point_{p}_view_{v}_domain_fixatedpose.json + camera_poses.json).
Standard library only.
"""
from __future__ import annotations

import json
import os
import re

FILENAME_RE = re.compile(r"point_(\w+)_view_(\w+)_domain_(\w+)\.(\w+)")


def file_name_for(directory: str, point_uuid, view_number, task: str, ext: str,
                  trajectory: bool = False) -> str:
    view = str(view_number).zfill(4) if trajectory else view_number
    return os.path.join(
        directory, f"point_{point_uuid}_view_{view}_domain_{task}.{ext}"
    )


def parse_filename(path: str):
    """-> (point, view, domain, ext) or None."""
    m = FILENAME_RE.match(os.path.basename(path))
    if not m:
        return None
    return m.group(1), m.group(2), m.group(3), m.group(4)


def save_point_info(basepath: str, point_infos) -> None:
    """Write point_info/*.json like save_point_data (generate_points.py:570-604)."""
    d = os.path.join(basepath, "point_info")
    os.makedirs(d, exist_ok=True)
    for views in point_infos:
        for view in views:
            p = file_name_for(
                d, view["point_uuid"], view["view_id"], "fixatedpose", "json"
            )
            with open(p, "w") as fh:
                json.dump(view, fh)


def load_point_info(basepath: str):
    """Read all point_info JSONs -> list-of-lists ordered by (point, view),
    like io_utils.load_saved_points_of_interest."""
    d = os.path.join(basepath, "point_info")
    by_point: dict = {}
    for name in sorted(os.listdir(d)):
        parsed = parse_filename(name)
        if not parsed or parsed[2] != "fixatedpose":
            continue
        view = json.load(open(os.path.join(d, name)))
        by_point.setdefault(str(view["point_uuid"]), []).append(view)
    out = []
    for p in sorted(by_point, key=lambda s: (len(s), s)):
        out.append(sorted(by_point[p], key=lambda v: int(v["view_id"])))
    return out


def save_camera_poses(basepath: str, cam_locs, quaternions=None) -> None:
    """camera_poses.json: list of {camera_id, location, rotation_quaternion}."""
    cams = []
    for i, loc in enumerate(cam_locs):
        cams.append(
            {
                "camera_id": str(i).zfill(4),
                "location": [float(x) for x in loc],
                "rotation_quaternion": (
                    [float(x) for x in quaternions[i]] if quaternions is not None
                    else [1.0, 0.0, 0.0, 0.0]
                ),
            }
        )
    with open(os.path.join(basepath, "camera_poses.json"), "w") as fh:
        json.dump(cams, fh)
