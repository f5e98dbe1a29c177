"""AOT program cache: compile the bucket ladder once, boot replicas warm.

Counterpart of ``distributedpytorch_tpu/serve/aot.py``, with its names and
its trust rules::

    python -m distributedpytorch_tpu_torch.serve.aot --cache-dir C \\
        --fresh-init 512:resnet101:0 --max-batch 2        # once
    python -m distributedpytorch_tpu_torch.serve --fresh-init \\
        512:resnet101:0 --max-batch 2 --warmup --aot-cache C   # every boot

A program is the device part of one bucket's forward (:func:`ladder_programs`:
the input's normalisation, the cast to the compute dtype, the model, and
for ``forward``/``decode`` the fused head's sigmoid), exported with
``torch.export`` and built by AOTInductor
(``torch._inductor.aoti_compile_and_package``) into one ``.pt2`` package:
a compiled shared library with the weights baked in as constants, as
XLA's serialized executable bakes its parameters.  The three attention
kernels stay in the package as the opaque ``dptpu`` operators
(``ops/cuda_attention.py``), so a package launches the hand-written
kernels, not traced plain forms.  ``build`` writes one package per
program and a manifest; a warm boot loads the packages
(AOTInductor's package loader, no compile: 0 on
:class:`..utils.compile_watchdog.CompileWatchdog`) and installs each in
the predictor's per-shape table (:meth:`..predict.Predictor.install_aot`).
Without a cache the service warms eagerly, the port's ordinary serving
path.

Trust is explicit:

* **the manifest is written atomically and last** (temporary file, fsync,
  ``os.replace``; each package the same way before it): a crashed build
  leaves no manifest, never a half-trusted one;
* **every entry carries its bytes and a crc32**, checked again on every
  load (and by ``--verify``): a torn or bit-rotted package is a typed
  :class:`AotCacheError`, never loaded, and the boot warms that program
  eagerly, loudly;
* **the cache key is the full identity of the compiled program**
  (:func:`cache_fingerprint`): torch and CUDA versions, the platform, the
  card's name and compute capability (an AOTInductor library is built for
  one architecture), the shape (resolution, channels, split), the model's
  architecture (``build_model``'s arguments) and a digest of the port's
  code the graph is traced from, the compute dtype, the normalisation the program bakes, the quantization
  regime, and a digest of the served weights, which the package bakes.
  Any mismatch is an :class:`AotCacheMiss` naming the keys that differ;
* **every package loads back before the manifest commits**, and the build
  compiles afresh: Inductor's on-disk caches are off for its duration
  (``force_disable_caches``), and a package that does not run, or gives
  non-finite output on zeros, is refused;
* the ``serve/aot_load`` chaos site fires on the raw bytes before the
  checksum, so an injected bitflip surfaces as the checksum error.

What it costs: the port's eager forward compiles nothing, so a warm
boot has no compile to skip and serves at the eager speed, and each
package holds its own copy of the weights on the card, which
AOTInductor allocates outside PyTorch's caching allocator (invisible to
``torch.cuda.memory_allocated``, and so to the hot swap's and the
session store's accounting).  A package is the port's place for what
the eager path cannot carry; until it carries some, the cache serves the
zero-compile boot contract alone.

The build runs under the port's float32 policy (TF32 off for matmuls and
convolutions, restored after).  Every model the port serves exports, a
MoE head (``model.moe_experts > 0``) included: its index form routes into
fixed-capacity slots, so no shape depends on the data.

TRUST BOUNDARY: the crc32 detects rot, not tampering.  A package holds a
compiled shared library, so loading one runs native code, and the
checksum lives in the same directory as the bytes it covers: whoever can
write the cache directory can run code in every replica that boots from
it.  Give the cache directory exactly the trust of the checkpoint itself
(the same access control, the same provenance).

``manifest`` and ``verify`` use only zlib and json: ``--verify`` builds no
predictor and touches no card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
from torch import nn

from ..chaos import sites as chaos_sites
from ..predict import _normalize

MANIFEST = "manifest.json"

#: manifest schema version: bump on layout changes so an old cache misses
#: loudly instead of loading a package it cannot describe
CACHE_VERSION = 1


class AotCacheMiss(KeyError):
    """No usable entry: an absent cache, manifest or program, or a
    fingerprint mismatch (another torch, card, weights, ...).  Expected in
    normal operation: the caller warms eagerly and says so."""

    def __str__(self) -> str:  # KeyError quotes its arg; keep it prose
        return self.args[0] if self.args else ""


class AotCacheError(RuntimeError):
    """A present entry that cannot be trusted: checksum mismatch, torn
    file, a package that does not load.  The caller falls back loudly and
    never runs it."""


def params_fingerprint(predictor) -> str:
    """sha256 over the served model's ``state_dict`` (parameters and
    BatchNorm statistics; int8 ``weight_q``/``weight_scale`` buffers on a
    quantized model, so the float32 and int8 forms of one checkpoint never
    collide): the piece of the key that pins which weights the package
    baked."""
    from ..train.checkpoint import param_digest

    return param_digest(predictor.model.state_dict())


def _device_name(device) -> str:
    """``cpu``, or the card's name and compute capability."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    major, minor = torch.cuda.get_device_capability(device)
    return f"{torch.cuda.get_device_name(device)} sm_{major}{minor}"


#: the port's sources a package's graph is traced from (the model, its
#: operators and plain forms, the programs, int8 serving), relative to the
#: package's root: a change to any of them changes what a package computes
_PROGRAM_SOURCES = ("models", "ops", "parallel/moe.py", "predict.py",
                    "serve/aot.py", "serve/quantize.py")
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def code_fingerprint() -> str:
    """sha256 over the ``.py`` files of :data:`_PROGRAM_SOURCES`, by path
    and bytes: a cache built before a fix to the model's code misses."""
    import hashlib

    root = _PACKAGE_ROOT
    files = []
    for src in _PROGRAM_SOURCES:
        path = os.path.join(root, src)
        if os.path.isdir(path):
            files += [os.path.join(path, f) for f in os.listdir(path)
                      if f.endswith(".py")]
        else:
            files.append(path)
    h = hashlib.sha256()
    for path in sorted(files):
        with open(path, "rb") as f:
            data = f.read()
        h.update(f"{os.path.relpath(path, root)}\0{len(data)}\0".encode())
        h.update(data)
    return h.hexdigest()


def model_fingerprint(predictor) -> dict:
    """The served model's architecture: the arguments ``build_model`` kept
    (``output_stride``, ``attention_impl``, ``pam_impl``, ... change the
    forward, not the ``state_dict``), the compute dtype left to the
    ``dtype`` key.  A model built otherwise has no architecture the cache
    can key: ``ValueError``."""
    args = getattr(predictor.model, "build_args", None)
    if args is None:
        raise ValueError(
            f"{type(predictor.model).__name__} was not built by "
            "models.build_model, so its architecture is unknown to the AOT "
            "cache's key")
    return {k: v for k, v in args.items() if k != "dtype"}


def cache_fingerprint(predictor) -> dict:
    """The full identity a cache entry is valid under.  Every key is
    load-bearing: a package is bound to its torch and CUDA, to one card
    architecture, to its shapes, to the model's architecture and the
    port's code it was traced from, to the dtype it computes in, to the
    normalisation constants and the (possibly quantized) weights it
    bakes."""
    from .quantize import quantization_block

    def stats(vals):
        return None if vals is None else [float(v) for v in vals]

    return {
        "cache_version": CACHE_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": predictor.device.type,
        "device": _device_name(predictor.device),
        "resolution": list(predictor.resolution),
        "in_channels": int(getattr(predictor, "in_channels", 4)),
        "split": bool(getattr(predictor, "supports_sessions", False)),
        "model": model_fingerprint(predictor),
        "code": code_fingerprint(),
        "dtype": str(predictor.dtype).removeprefix("torch."),
        "normalize": [stats(predictor.mean), stats(predictor.std)],
        "quantization": quantization_block(
            getattr(predictor, "quant_policy", None)),
        "params_digest": params_fingerprint(predictor),
    }


def fingerprint_mismatch(saved: dict, live: dict) -> list[str]:
    """The keys on which two fingerprints disagree (empty: compatible),
    each with both values, so that a miss names what moved."""
    keys = sorted(set(saved) | set(live))
    return [f"{k}: cached {saved.get(k)!r} != live {live.get(k)!r}"
            for k in keys if saved.get(k) != live.get(k)]


class ForwardProgram(nn.Module):
    """(B, H, W, C) float32 prepared crops -> (B, H, W) float32
    probabilities: :meth:`Predictor.forward_prepared`'s device part."""

    def __init__(self, pred):
        super().__init__()
        self.model, self.dtype = pred.model, pred.dtype
        self.mean, self.std = pred.mean, pred.std

    def forward(self, x):
        x = _normalize(x.permute(0, 3, 1, 2), self.mean, self.std)
        logits = self.model(x.to(self.dtype).contiguous())[0]
        return torch.sigmoid(logits.float())[:, 0]


class EncodeProgram(nn.Module):
    """(B, H, W, C - 1) RGB crops -> the backbone's features:
    :meth:`Predictor.encode`'s device part."""

    def __init__(self, pred):
        super().__init__()
        self.model, self.dtype = pred.model, pred.dtype
        self.stats = pred._rgb_stats

    def forward(self, rgb):
        x = _normalize(rgb.permute(0, 3, 1, 2), *self.stats)
        return self.model(x.to(self.dtype).contiguous(), stage="encode")


class DecodeProgram(nn.Module):
    """Features + (B, H, W, 1) guidance -> (B, H, W) float32
    probabilities: :meth:`Predictor.decode_device`."""

    def __init__(self, pred):
        super().__init__()
        self.model, self.dtype = pred.model, pred.dtype
        self.stats = pred._guidance_stats
        self.resolution = tuple(pred.resolution)

    def forward(self, features, guidance):
        g = _normalize(guidance.permute(0, 3, 1, 2), *self.stats)
        logits = self.model((features, g.to(self.dtype).contiguous()),
                            stage="decode", out_size=self.resolution)[0]
        return torch.sigmoid(logits.float())[:, 0]


def ladder_programs(predictor, buckets) -> list[tuple]:
    """``[(name, module, example_inputs, install_key), ...]``: the bucket
    ladder's programs for one predictor, the ones
    ``InferenceService.warmup`` readies.  Per bucket, one whole forward
    (``forward_b{b}``, key ``("forward", (B, H, W, C))``) for a stem
    predictor; an encode and a decode (``encode_b{b}``/``decode_b{b}``,
    keys ``("encode", b)``/``("decode", b)``) for a split one.  The
    example inputs are ``meta`` tensors, shapes and dtypes only (JAX's
    ``ShapeDtypeStruct``s); :func:`example_inputs` places them."""
    h, w = predictor.resolution
    ch = int(getattr(predictor, "in_channels", 4))

    def zeros(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = []
    if getattr(predictor, "supports_sessions", False):
        feats = predictor.feature_struct(1)
        enc = EncodeProgram(predictor).eval()
        dec = DecodeProgram(predictor).eval()
        for b in buckets:
            out.append((f"encode_b{b}", enc, (zeros(b, h, w, ch - 1),),
                        ("encode", b)))
            out.append((f"decode_b{b}", dec,
                        (zeros(b, *feats.shape[1:], dtype=feats.dtype),
                         zeros(b, h, w, 1)), ("decode", b)))
    else:
        fwd = ForwardProgram(predictor).eval()
        for b in buckets:
            shape = (b, h, w, ch)
            out.append((f"forward_b{b}", fwd, (zeros(*shape),),
                        ("forward", shape)))
    return out


def example_inputs(args, device) -> tuple:
    """A program's ``meta`` example inputs as zeros on ``device``."""
    return tuple(torch.zeros(a.shape, dtype=a.dtype, device=device)
                 for a in args)


def export_program(module, args):
    """``torch.export`` of one program on its placed example inputs, for
    inference (no grad)."""
    with torch.no_grad():
        return torch.export.export(module, tuple(args), strict=False)


def _openmp_cxx() -> str:
    """The C++ compiler AOTInductor links a package's wrapper with.  On
    Linux Inductor links it with ``-fopenmp -lgomp``, which a toolchain
    installed without libgomp cannot do, so take Inductor's own choice
    (``$CXX``, else ``g++``) when it links a trial library that way, else
    the first of ``c++`` and ``g++`` (on the path, then in ``/usr/bin``)
    that does."""
    tried: list[str] = []
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "omp.cpp")
        with open(src, "w") as f:
            f.write("int dptpu_openmp_probe() { return 1; }\n")
        for cand in (os.environ.get("CXX", "g++"), "c++", "g++",
                     "/usr/bin/c++", "/usr/bin/g++"):
            path = shutil.which(cand)
            if path is None or path in tried:
                continue
            tried.append(path)
            r = subprocess.run([path, "-fopenmp", "-shared", "-fPIC", src,
                                "-o", os.path.join(d, "omp.so"), "-lgomp"],
                               capture_output=True)
            if r.returncode == 0:
                return path
    raise RuntimeError(
        f"AotCache.build: no C++ compiler here links with -fopenmp -lgomp "
        f"(tried {tried}), as AOTInductor links a package; set CXX to one "
        "that does")


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class LoadedProgram:
    """A loaded package: AOTInductor's C++ runner, called on the program's
    tensor inputs, returning its one output.  Built on
    ``torch._C._aoti.AOTIModelPackageLoader`` directly, as
    ``aoti_load_package`` is: that one's Python wrapper imports Inductor,
    some seconds of a fresh process's boot for nothing a program with
    tensor inputs and one output needs."""

    def __init__(self, loader):
        self.loader = loader

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        return self.loader.run(list(inputs))[0]


def _load_package(data: bytes, what: str) -> LoadedProgram:
    """A package from its checked bytes (the dptpu operators registered
    first; the loader unpacks a file, so the bytes go to a temporary one);
    any failure is an :class:`AotCacheError`."""
    from ..ops import cuda_attention  # noqa: F401 — registers torch.ops.dptpu

    try:
        with tempfile.NamedTemporaryFile(suffix=".pt2") as f:
            f.write(data)
            f.flush()
            return LoadedProgram(torch._C._aoti.AOTIModelPackageLoader(
                f.name, "model", False, 1, -1))
    except Exception as e:
        raise AotCacheError(
            f"{what} failed to load ({type(e).__name__}: {e}) — stale "
            "package format or corruption; rebuild the cache") from e


class AotCache:
    """One cache directory: a ``.pt2`` package per program and the
    atomically written manifest.

    ``verify`` and ``manifest`` read files only; ``build`` and ``load``
    export, compile and load packages."""

    def __init__(self, cache_dir: str):
        self.cache_dir = str(cache_dir)

    # ---------------------------------------------------------- manifest

    def manifest_path(self) -> str:
        return os.path.join(self.cache_dir, MANIFEST)

    def manifest(self) -> dict:
        """The parsed manifest.  Missing: :class:`AotCacheMiss` (never
        built, or the build died before its commit); unparseable or
        schema-invalid: :class:`AotCacheError` (the atomic write makes a
        torn manifest a corruption, not a crash artefact)."""
        try:
            with open(self.manifest_path(), encoding="utf-8") as f:
                raw = f.read()
        except OSError:
            raise AotCacheMiss(
                f"no AOT manifest at {self.manifest_path()} — build one "
                "with `python -m distributedpytorch_tpu_torch.serve.aot "
                "--cache-dir ...`") from None
        try:
            man = json.loads(raw)
            if not isinstance(man, dict) \
                    or not isinstance(man.get("entries"), dict) \
                    or not isinstance(man.get("fingerprint"), dict):
                raise ValueError("manifest missing entries/fingerprint")
            for name, ent in man["entries"].items():
                # every entry record is checked here, so that a valid but
                # mangled manifest stays inside the typed fallback (load
                # and verify index into these fields)
                if (not isinstance(ent, dict)
                        or not isinstance(ent.get("file"), str)
                        or not isinstance(ent.get("bytes"), int)
                        or not isinstance(ent.get("crc32"), int)):
                    raise ValueError(
                        f"entry {name!r} malformed (want file/bytes/"
                        f"crc32, got {ent!r})")
        except ValueError as e:
            raise AotCacheError(
                f"unreadable AOT manifest {self.manifest_path()}: {e} — "
                "rebuild the cache") from None
        return man

    # ------------------------------------------------------------- build

    def build(self, predictor, buckets) -> dict:
        """Export, compile and package every program of the ladder, load
        each back, then commit the manifest; returns a summary with each
        program's build seconds and the compiles a
        :class:`..utils.compile_watchdog.CompileWatchdog` counted."""
        import torch._inductor.config as inductor_config

        from ..utils.compile_watchdog import CompileWatchdog

        fingerprint = cache_fingerprint(predictor)
        os.makedirs(self.cache_dir, exist_ok=True)
        entries: dict[str, dict] = {}
        seconds: dict[str, float] = {}
        total = 0
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            # a genuinely fresh build: nothing served from Inductor's
            # on-disk caches, whatever an earlier compile left there
            with inductor_config.patch({"force_disable_caches": True,
                                        "cpp.cxx": (None, _openmp_cxx())}), \
                    CompileWatchdog() as watchdog:
                for name, module, meta, _key in ladder_programs(predictor,
                                                                buckets):
                    t0 = time.perf_counter()
                    args = example_inputs(meta, predictor.device)
                    ep = export_program(module, args)
                    fname = f"{name}.pt2"
                    path = os.path.join(self.cache_dir, fname)
                    tmp = os.path.join(self.cache_dir, f".{name}.build.pt2")
                    torch._inductor.aoti_compile_and_package(
                        ep, package_path=tmp)
                    with open(tmp, "rb") as f:
                        data = f.read()
                    os.remove(tmp)
                    # the round trip: a package that does not load and run
                    # here would poison every warm boot
                    program = _load_package(
                        data, f"freshly built package {name!r}")
                    with torch.no_grad():
                        out = program(*args)
                    if not torch.isfinite(out).all():
                        raise AotCacheError(
                            f"freshly built package {name!r} gives "
                            "non-finite output on zeros — refusing to "
                            "commit it")
                    del program
                    _write_atomic(path, data)
                    entries[name] = {"file": fname, "bytes": len(data),
                                     "crc32": zlib.crc32(data)}
                    total += len(data)
                    seconds[name] = round(time.perf_counter() - t0, 3)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        # the manifest commits the cache as a unit, atomically and last: a
        # build that dies above leaves packages but no manifest, a miss
        from ..train.checkpoint import atomic_write_json

        atomic_write_json(self.manifest_path(),
                          {"version": CACHE_VERSION,
                           "fingerprint": fingerprint,
                           "entries": entries})
        return {"cache_dir": self.cache_dir,
                "programs": sorted(entries),
                "bytes": total,
                "seconds": seconds,
                "compiles": dict(watchdog.counts),
                "fingerprint": fingerprint}

    # -------------------------------------------------------------- load

    def load(self, name: str, fingerprint: dict) -> LoadedProgram:
        """One entry -> a :class:`LoadedProgram` (callable on the program's
        inputs).

        Raises :class:`AotCacheMiss` (absent, or a fingerprint mismatch
        naming every differing key) or :class:`AotCacheError` (present but
        untrustworthy: checksum mismatch, does not load).  The
        ``serve/aot_load`` chaos site fires on the raw bytes before the
        checksum, so that rot injected there surfaces as the checksum
        failure and never reaches the loader."""
        man = self.manifest()
        mismatch = fingerprint_mismatch(man["fingerprint"], fingerprint)
        if mismatch:
            raise AotCacheMiss(
                "AOT cache fingerprint mismatch — the cached packages were "
                "built for a different " + "; ".join(mismatch))
        ent = man["entries"].get(name)
        if ent is None:
            raise AotCacheMiss(
                f"no cached package for program {name!r} "
                f"(cache holds: {sorted(man['entries'])})")
        path = os.path.join(self.cache_dir, ent["file"])
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise AotCacheMiss(
                f"cached package file missing for {name!r}: {e}") from None
        # chaos seam: bit rot between the disk and the loader, on a uint8
        # view; a bitflip fault returns a flipped copy the crc must catch
        arr = np.frombuffer(data, dtype=np.uint8)
        fired = chaos_sites.fire("serve/aot_load", payload=arr, name=name,
                                 path=path)
        if fired is not arr:
            data = np.asarray(fired, dtype=np.uint8).tobytes()
        if len(data) != int(ent["bytes"]) \
                or zlib.crc32(data) != int(ent["crc32"]):
            raise AotCacheError(
                f"checksum mismatch for cached package {name!r} ({path}): "
                f"{len(data)} bytes crc {zlib.crc32(data)} vs manifest "
                f"{ent['bytes']} bytes crc {ent['crc32']} — torn write or "
                "bit rot; rebuild the cache (or delete the directory)")
        return _load_package(data, f"cached package {name!r}")

    # ------------------------------------------------------------ verify

    def verify(self) -> dict:
        """Checksum every entry again (zlib only: no torch, no card).
        Returns ``{"entries": n, "bad": [...], "missing": [...],
        "fingerprint": ...}``: ``bad`` names entries whose bytes no longer
        match their manifest record, ``missing`` those whose file is
        gone."""
        man = self.manifest()
        bad: list[str] = []
        missing: list[str] = []
        for name, ent in sorted(man["entries"].items()):
            path = os.path.join(self.cache_dir, ent["file"])
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                missing.append(name)
                continue
            if len(data) != int(ent["bytes"]) \
                    or zlib.crc32(data) != int(ent["crc32"]):
                bad.append(name)
        return {"entries": len(man["entries"]), "bad": bad,
                "missing": missing, "fingerprint": man.get("fingerprint")}


# ------------------------------------------------------------------- CLI

def main(argv: list[str] | None = None, predictor=None) -> int:
    """``python -m distributedpytorch_tpu_torch.serve.aot``: build or
    verify a cache.

    Build (the default): ``--cache-dir C`` and the server's model source
    (``--fresh-init``, ``--state-dict`` or ``--run-dir [--step]``, with
    ``--device``, ``--backbone``, ``--resolution`` and ``--quantize``
    resolved as the server resolves them) and ``--max-batch``: the exact
    ladder the server with those flags warms.  ``--verify`` checksums
    every entry again and exits 1 naming the bad ones (2 with no cache),
    with no predictor and no card.  ``predictor`` injects a built one."""
    import argparse

    from .__main__ import add_model_source_args

    parser = argparse.ArgumentParser(
        prog="distributedpytorch_tpu_torch.serve.aot",
        description="Build (and verify) the serve bucket ladder's AOT "
                    "program cache, for `python -m "
                    "distributedpytorch_tpu_torch.serve --warmup "
                    "--aot-cache`.")
    parser.add_argument("--cache-dir", required=True,
                        help="cache directory (packages + manifest)")
    parser.add_argument("--verify", action="store_true",
                        help="checksum every cache entry instead of "
                             "building; exit 1 naming bad entries")
    parser.add_argument("--max-batch", type=int, default=8,
                        help="top micro-batch bucket (power of two); must "
                             "match the server's")
    add_model_source_args(parser, required=False)
    args = parser.parse_args(argv)

    cache = AotCache(args.cache_dir)
    if args.verify:
        try:
            report = cache.verify()
        except (AotCacheMiss, AotCacheError) as e:
            print(f"serve.aot: {e}", file=sys.stderr)
            return 2
        print(json.dumps(report, indent=1, sort_keys=True))
        if report["bad"] or report["missing"]:
            print(f"serve.aot: {len(report['bad'])} corrupt + "
                  f"{len(report['missing'])} missing entr(ies): "
                  f"{report['bad'] + report['missing']} — rebuild the "
                  "cache (a boot would warm those programs eagerly)",
                  file=sys.stderr)
            return 1
        print(f"serve.aot: {report['entries']} entr(ies) verified",
              file=sys.stderr)
        return 0

    if predictor is None:
        if not (args.fresh_init or args.state_dict or args.run_dir):
            parser.error("build needs --fresh-init, --state-dict or "
                         "--run-dir (or pass --verify)")
        from .__main__ import build_predictor

        predictor = build_predictor(args)
    from .batching import bucket_sizes

    summary = cache.build(predictor, bucket_sizes(args.max_batch))
    print(json.dumps(summary, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
