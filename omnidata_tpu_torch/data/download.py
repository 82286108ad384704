"""omnitools.download — the starter-dataset fetch/verify/untar CLI.

Capability match for omnidata_tools/dataset/download.py:216-309 +
metadata.py: remote link/md5 manifests -> ZippedModel records -> filter by
domains/components/subset/split -> striped across machines -> download with
retries + md5 verification -> extract the tar_structure subpath into
dest/domain/component/model, skipping work already done.

Differences from the reference by design:
- urllib (stdlib) with an optional aria2c backend instead of a hard aria2
  RPC dependency; file:// manifests/tars work, so everything is testable
  offline (this machine is zero-egress).
- license clickthrough is kept (--agree_all + name/email) but the Google-Form
  POST is attempted best-effort and skipped without network.

The port's copy of ``omnidata_tpu.data.download``. After a failed attempt
``process_model`` removes the partial tar and aria2's ``.aria2`` control
file, so the retry fetches afresh (there, the stale tar was kept whenever a
checksum was known, and the next attempt spent itself failing the md5
check); and the subset ladder derived from the remote listing groups models
by ``component_name`` (there, a ``component`` attribute that ZippedModel
lacks).

Usage:
    python -m omnidata_tpu_torch.data.download rgb normal --components replica \
        --subset debug --dest ./omnidata_starter_dataset/ --agree_all
"""
from __future__ import annotations

import argparse
import hashlib
import os
import re
import shutil
import subprocess
import tarfile
import tempfile
import urllib.request
from dataclasses import dataclass
from typing import Optional


class bcolors:
    HEADER = "\033[95m"
    OKGREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"
    ENDC = "\033[0m"


def notice(msg):
    print(f"[{bcolors.OKGREEN}{bcolors.BOLD}NOTICE{bcolors.ENDC}] {msg}")


def failure(msg):
    print(f"[{bcolors.FAIL}{bcolors.BOLD}FAILURE{bcolors.ENDC}] {msg}")


EMAIL_REGEX = r"\b[A-Za-z0-9._%+-]+@[A-Za-z0-9.-]+\.[A-Z|a-z]{2,}\b"

STARTER_DATA_LICENSES = {
    "omnidata": "https://raw.githubusercontent.com/EPFL-VILAB/omnidata/main/LICENSE",
    "taskonomy": "https://raw.githubusercontent.com/StanfordVL/taskonomy/master/data/LICENSE",
    "replica": "https://raw.githubusercontent.com/facebookresearch/Replica-Dataset/main/LICENSE",
    "gso": "https://creativecommons.org/licenses/by/4.0/",
    "hypersim": "https://raw.githubusercontent.com/apple/ml-hypersim/main/LICENSE.txt",
    "blended_mvg": "https://creativecommons.org/licenses/by/4.0/",
    "hm3d": "https://matterport.com/matterport-end-user-license-agreement-academic-use-model-data",
    "clevr_simple": "https://creativecommons.org/licenses/by/4.0/",
    "clevr_complex": "https://creativecommons.org/licenses/by/4.0/",
}


@dataclass
class ZippedModel:
    component_name: str
    domain: str
    model_name: str
    url: str
    tar_structure: tuple = ("domain", "component_name", "model_name")
    checksum: Optional[str] = None

    @property
    def ext(self):
        return ".".join(self.url.split("/")[-1].split(".")[1:])

    @property
    def fname(self):
        return f"{self.domain}__{self.component_name}__{self.model_name}.{self.ext}"


def _fetch_text(url: str) -> str:
    with urllib.request.urlopen(url) as r:
        return r.read().decode()


class RemoteStorageMetadata:
    """links.txt + md5sum.txt manifests at base_url (metadata.py:41-87)."""

    def __init__(self, base_url: str, expected_suffix: str = ".tar",
                 tar_structure=("domain", "component_name", "model_name")):
        self.base_url = base_url.rstrip("/")
        self.link_file = f"{self.base_url}/links.txt"
        self.checksum_file = f"{self.base_url}/md5sum.txt"
        self.expected_suffix = expected_suffix
        self.tar_structure = tar_structure
        self._links = self._checksums = None

    @property
    def links(self):
        if self._links is None:
            self._links = [
                k for k in _fetch_text(self.link_file).splitlines()
                if k.endswith(self.expected_suffix)
            ]
        return self._links

    @property
    def checksums(self):
        if self._checksums is None:
            try:
                self._checksums = {
                    line.split()[1]: line.split()[0]
                    for line in _fetch_text(self.checksum_file).splitlines()
                    if line.endswith(self.expected_suffix)
                }
            except Exception:
                self._checksums = {}
        return self._checksums

    def checksum(self, url: str):
        return self.checksums.get(url.replace(self.base_url, "").lstrip("/")) or \
            self.checksums.get(url.replace(self.base_url, ""))

    @property
    def models(self):
        return [self.parse(u) for u in self.links]

    def parse(self, url: str) -> ZippedModel:
        raise NotImplementedError


class OmnidataMetadata(RemoteStorageMetadata):
    """URL scheme .../omnidata_tars/<domain>/<component>/<domain>-<component>-<model>.tar
    (starter_dataset/__init__.py:12-38)."""

    def parse(self, url: str) -> ZippedModel:
        if not url.endswith(self.expected_suffix):
            raise ValueError(f"expected suffix {self.expected_suffix}: {url}")
        parts = url.split("/")
        domain, component, fname = parts[-3], parts[-2], parts[-1]
        stem = fname[: -len(self.expected_suffix)]
        d2, c2, *model = stem.split("-")
        if c2 != component:
            raise ValueError(f"component mismatch: {c2} vs {component} in {url}")
        if d2 != domain:
            raise ValueError(f"domain mismatch: {d2} vs {domain} in {url}")
        if not model:
            raise ValueError(f"empty model name in {fname}")
        return ZippedModel(component, domain, "-".join(model), url,
                           self.tar_structure, self.checksum(url))


class TaskonomyMetadata(RemoteStorageMetadata):
    """URL scheme .../taskonomy/<model>_<domain>.tar
    (starter_dataset/__init__.py:40-56)."""

    def __init__(self, base_url, expected_suffix=".tar",
                 tar_structure=("domain",)):
        super().__init__(base_url, expected_suffix, tar_structure)

    def parse(self, url: str) -> ZippedModel:
        if not url.endswith(self.expected_suffix):
            raise ValueError(f"expected suffix {self.expected_suffix}: {url}")
        parts = url.split("/")
        if parts[-2].split(":")[-1] and parts[-2] not in ("taskonomy",) and not parts[-2].endswith("taskonomy"):
            raise ValueError(f'expected component "taskonomy" in url: {url}')
        stem = parts[-1][: -len(self.expected_suffix)]
        model, *domain = stem.split("_")
        if not domain:
            raise ValueError(f"empty domain in {stem}")
        domain = "_".join(domain)
        ts = ("domain", "model_name") if domain == "fragments" else self.tar_structure
        return ZippedModel("taskonomy", domain, model, url, ts, self.checksum(url))


DEFAULT_SERVERS = [
    lambda: OmnidataMetadata("https://datasets.epfl.ch/omnidata/", ".tar"),
    lambda: TaskonomyMetadata("https://datasets.epfl.ch/taskonomy/"),
]


def filter_models(models, domains, subset, split, components,
                  component_to_split=None, component_to_subset=None):
    """download.py:100-125 filter semantics."""
    component_to_split = component_to_split or {}
    component_to_subset = component_to_subset or {}
    out = []
    for m in models:
        c = m.component_name.lower()
        if c not in components:
            continue
        sub = component_to_subset.get(c)
        if subset != "all" and sub is not None and m.model_name not in sub.get(subset, ()):
            continue
        sp = component_to_split.get(c)
        if split != "all" and sp is not None and m.model_name not in sp:
            continue
        if "all" not in domains and m.domain not in domains:
            continue
        out.append(m)
    return out


def md5sum(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as fh:
        while True:
            b = fh.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def download_file(url: str, dest: str, use_aria2: bool = False,
                  connections: int = 8, checksum: str | None = None) -> None:
    """Fetch one file. With use_aria2, prefer the persistent RPC daemon
    (reference download.py:129-140), then the one-shot aria2c CLI, then
    plain urllib — all three are interchangeable here."""
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    if use_aria2:
        from . import aria2_rpc
        daemon = aria2_rpc.ensure_daemon(connections_total=connections)
        if daemon is not None:
            daemon.download(url, dest, checksum=checksum)
            return
        if shutil.which("aria2c"):
            subprocess.run(
                ["aria2c", "-x", str(connections),
                 "-o", os.path.basename(dest),
                 "-d", os.path.dirname(dest), url],
                check=True,
            )
            return
    with urllib.request.urlopen(url) as r, open(dest, "wb") as fh:
        shutil.copyfileobj(r, fh)


def model_dest_dir(model: ZippedModel, dest: str) -> str:
    return os.path.join(dest, model.domain, model.component_name, model.model_name)


def untar(tar_path: str, model: ZippedModel, dest: str) -> str:
    """Extract to a tempdir, then move the tar_structure subpath into
    dest/domain/component/model (download.py:196-212). Skips if extracted."""
    out_dir = model_dest_dir(model, dest)
    if os.path.isdir(out_dir) and os.listdir(out_dir):
        return out_dir
    with tempfile.TemporaryDirectory(dir=os.path.dirname(dest) or ".") as tmp:
        with tarfile.open(tar_path) as tf:
            tf.extractall(tmp, filter="data")
        # find the innermost tar_structure path
        sub = tmp
        for part in model.tar_structure:
            val = getattr(model, part)
            cand = os.path.join(sub, val)
            if os.path.isdir(cand):
                sub = cand
            else:
                found = [d for d in os.listdir(sub) if os.path.isdir(os.path.join(sub, d))]
                if len(found) == 1:
                    sub = os.path.join(sub, found[0])
                else:
                    # never move an ambiguous tree into dest: a wrong move
                    # both corrupts the layout and poisons the idempotent
                    # skip-if-extracted check on the next attempt
                    raise ValueError(
                        f"unexpected tar layout for {model.fname}: wanted "
                        f"{part}={val!r}, found {sorted(found)[:8]} under "
                        f"{os.path.relpath(sub, tmp) or '.'}"
                    )
        os.makedirs(os.path.dirname(out_dir), exist_ok=True)
        shutil.move(sub, out_dir)
    return out_dir


def process_model(model: ZippedModel, dest: str, dest_compressed: str,
                  ignore_checksum: bool = False, max_tries: int = 3,
                  keep_compressed: bool = False, use_aria2: bool = False,
                  errors: list | None = None) -> bool:
    out_dir = model_dest_dir(model, dest)
    if os.path.isdir(out_dir) and os.listdir(out_dir):
        return True  # idempotent skip (download.py:202,281)
    tar_path = os.path.join(dest_compressed, model.fname)
    for attempt in range(max_tries):
        try:
            if not os.path.exists(tar_path):
                download_file(model.url, tar_path, use_aria2,
                              checksum=None if ignore_checksum
                              else model.checksum)
            if not ignore_checksum and model.checksum:
                if md5sum(tar_path) != model.checksum:
                    os.remove(tar_path)
                    raise IOError(f"checksum mismatch for {model.url}")
            untar(tar_path, model, dest)
            if not keep_compressed:
                os.remove(tar_path)
            return True
        except Exception as e:  # noqa: BLE001 — collect, keep going
            msg = f"attempt {attempt + 1}/{max_tries} failed for {model.url}: {e}"
            failure(msg)
            # the tar (partial, corrupt or unverifiable) and aria2's control
            # file go, so the retry re-fetches instead of reusing them
            for stale in (tar_path, tar_path + ".aria2"):
                if os.path.exists(stale):
                    os.remove(stale)
            if errors is not None and attempt == max_tries - 1:
                errors.append(msg)
    return False


def download(
    domains: list[str],
    subset: str = "debug",
    split: str = "train",
    components: list[str] = ("replica",),
    dest: str = "./omnidata_starter_dataset/",
    dest_compressed: str = "./omnidata_starter_dataset_compressed/",
    ignore_checksum: bool = False,
    agree_all: bool = False,
    name: str = "",
    email: str = "",
    num_chunk: int = 0,
    num_total_chunks: int = 1,
    max_tries_per_model: int = 3,
    use_aria2: bool = False,
    metadata_list=None,
    component_to_split=None,
    component_to_subset=None,
) -> list[str]:
    """Returns the list of extracted model directories."""
    # license clickthrough (download.py:70-88)
    comps = set(list(components) + ["omnidata"])
    print("Terms of use for the requested components:")
    for c in sorted(comps):
        print(f"    {c}: {STARTER_DATA_LICENSES.get(c, '(see component homepage)')}")
    if agree_all:
        if not (name and re.fullmatch(EMAIL_REGEX, email)):
            raise ValueError(
                "--agree_all requires --name NAME and a valid --email"
            )
        notice("Confirmation supplied by option '--agree_all'")
    else:
        res = input("Accept the above terms? [y/n]: ").lower()
        if res != "y":
            print("Agreement declined: cancelling download.")
            return []

    metadata_list = metadata_list or [f() for f in DEFAULT_SERVERS]
    models = []
    for md in metadata_list:
        models.extend(md.models)
    if component_to_subset is None and subset != "all":
        # No bundled split CSVs (offline build): derive the nested
        # debug ⊂ tiny ⊂ … ⊂ fullplus ladder per component from the remote
        # listing itself (splits.subset_ladder fractions), so --subset
        # actually narrows the fetch instead of silently no-opping.
        from .splits import subset_ladder

        by_comp: dict = {}
        for m in models:
            by_comp.setdefault(m.component_name, set()).add(m.model_name)
        component_to_subset = {
            c: subset_ladder(sorted(ns)) for c, ns in by_comp.items()
        }
        notice(f"--subset {subset}: ladder derived from the remote listing "
               "(pass component_to_subset for the published membership)")
    if component_to_split is None and split != "all":
        notice(f"--split {split}: split CSVs not bundled — no split filter "
               "applied (pass component_to_split from your CSVs)")
    models = filter_models(models, domains, subset, split,
                           [c.lower() for c in components],
                           component_to_split, component_to_subset)
    models = models[num_chunk::num_total_chunks]  # striping (download.py:271)
    notice(f"{len(models)} models to fetch (chunk {num_chunk}/{num_total_chunks})")

    os.makedirs(dest, exist_ok=True)
    os.makedirs(dest_compressed, exist_ok=True)
    errors: list[str] = []
    done = []
    for m in models:
        if process_model(m, dest, dest_compressed, ignore_checksum,
                         max_tries_per_model, use_aria2=use_aria2, errors=errors):
            done.append(model_dest_dir(m, dest))
    notice(f"Download complete: {len(done)} models, {len(errors)} failures")
    for e in errors:
        notice(f"  {e}")
    return done


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="omnitools.download",
        description="Download the Omnidata starter dataset.",
    )
    p.add_argument("domains", nargs="+", help="domains (or 'all')")
    p.add_argument("--subset", default="debug",
                   choices=["debug", "tiny", "medium", "full", "fullplus", "all"])
    p.add_argument("--split", default="train",
                   choices=["train", "val", "test", "all"])
    p.add_argument("--components", nargs="+", default=["replica"])
    p.add_argument("--dest", default="./omnidata_starter_dataset/")
    p.add_argument("--dest_compressed", default="./omnidata_starter_dataset_compressed/")
    p.add_argument("--ignore_checksum", action="store_true")
    p.add_argument("--agree_all", action="store_true")
    p.add_argument("--name", default="")
    p.add_argument("--email", default="")
    p.add_argument("--num_chunk", type=int, default=0)
    p.add_argument("--num_total_chunks", type=int, default=1)
    p.add_argument("--max_tries_per_model", type=int, default=3)
    p.add_argument("--use_aria2", action="store_true")
    a = p.parse_args(argv)
    download(
        a.domains, a.subset, a.split, a.components, a.dest, a.dest_compressed,
        a.ignore_checksum, a.agree_all, a.name, a.email, a.num_chunk,
        a.num_total_chunks, a.max_tries_per_model, a.use_aria2,
    )


if __name__ == "__main__":
    main()
