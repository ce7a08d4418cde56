"""Build and run the C++ binding of ``cpp_torch/`` with g++ against the
CPython of the running interpreter.

    python3 -m aerobulk_tpu_torch.cxx [--build DIR] [--device cuda|cpu]

builds ``cpp_torch``'s library and example into ``DIR`` (default
``cpp_torch/build``) and runs the example.  The one g++ line is what
``g++ ... $(python3-config --includes --ldflags --embed)`` gives, with the
paths read from ``sysconfig`` of this interpreter; the example runs with
this interpreter's site-packages on ``PYTHONPATH``, so that the embedded
interpreter finds torch.  ``cmake -S cpp_torch -B cpp_torch/build`` builds
the same with CMake.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import Optional

from .capi import DEVICE_ENV

REPO = Path(__file__).resolve().parent.parent
CPP = REPO / "cpp_torch"
EXAMPLE = "example_call_aerobulk"


def _python_include() -> Path:
    return Path(sysconfig.get_paths()["include"])


def _libpython() -> Optional[str]:
    """The directory that holds this interpreter's libpython, or None."""
    name = f"libpython{sysconfig.get_config_var('LDVERSION')}"
    for d in (sysconfig.get_config_var("LIBDIR"),
              sysconfig.get_config_var("LIBPL")):
        if d and glob.glob(os.path.join(d, name + ".*")):
            return d
    return None


def toolchain_missing() -> Optional[str]:
    """What the build lacks on this machine (g++, Python.h, libpython), or
    None when it has everything."""
    if shutil.which("g++") is None:
        return "g++"
    if not (_python_include() / "Python.h").exists():
        return f"Python.h (not in {_python_include()})"
    if _libpython() is None:
        return (f"libpython{sysconfig.get_config_var('LDVERSION')} (not in "
                f"{sysconfig.get_config_var('LIBDIR')})")
    return None


def compile_command(out: Path) -> list:
    """The g++ line that builds the library and the example into ``out``."""
    libdir = _libpython()
    return ["g++", "-std=c++14", "-O2", f"-I{CPP / 'include'}",
            f"-I{_python_include()}", str(CPP / "src" / "aerobulk.cpp"),
            str(CPP / "example" / f"{EXAMPLE}.cpp"), "-o", str(out),
            f"-L{libdir}", f"-lpython{sysconfig.get_config_var('LDVERSION')}",
            *sysconfig.get_config_var("LIBS").split(),
            *sysconfig.get_config_var("SYSLIBS").split(),
            f"-Wl,-rpath,{libdir}", "-rdynamic"]


def build_example(build_dir: Path = CPP / "build") -> Path:
    """Build the example into ``build_dir``; returns the executable.
    Raises ``RuntimeError`` with g++'s output when the build fails."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    exe = build_dir / EXAMPLE
    res = subprocess.run(compile_command(exe), capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cpp_torch: g++ failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    return exe


def example_env(device: Optional[str] = None) -> dict:
    """The environment of the example: the repository and this
    interpreter's site-packages (where torch is, a virtual environment's
    included) on ``PYTHONPATH``, and ``AEROBULK_CAPI_DEVICE`` set to
    ``device`` when one is named."""
    env = dict(os.environ)
    site = sysconfig.get_paths()
    paths = [str(REPO), site["purelib"], site["platlib"]]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    env.pop(DEVICE_ENV, None)
    if device is not None:
        env[DEVICE_ENV] = device
    return env


def run_example(exe: Path, device: Optional[str] = None,
                timeout: float = 600.0) -> subprocess.CompletedProcess:
    """Run the built example (on the CUDA device unless ``device`` names
    another) and return its completed process."""
    return subprocess.run([str(exe)], env=example_env(device),
                          capture_output=True, text=True, timeout=timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build", default=str(CPP / "build"))
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the binding's device (default: the CUDA device)")
    args = ap.parse_args(argv)
    missing = toolchain_missing()
    if missing:
        sys.exit(f"cpp_torch: cannot build, this machine lacks {missing}")
    res = run_example(build_example(Path(args.build)), args.device)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr)
    sys.exit(res.returncode)


if __name__ == "__main__":
    main()
