"""Fixture torch-hygiene build sites: trigger, suppression, clean counterpart."""

import ctypes
import shutil
import subprocess

from .obs.introspect import record_build
from .ops.fold_cuda import compile_library, nvcc_path

CXX = shutil.which("g++") or "c++"


def build_unrecorded(src, out):
    cmd = [nvcc_path(), "-shared", "-o", out, src]
    subprocess.run(cmd, check=True)  # expect: build-unrecorded


def build_unrecorded_cxx(src, out):
    subprocess.Popen([CXX, "-O2", "-o", out, src]).wait()  # expect: build-unrecorded


def build_silenced(src, out):
    subprocess.run([nvcc_path(), "-o", out, src])  # verifylint: disable=build-unrecorded


def build_recorded(src, out):
    subprocess.run([nvcc_path(), "-o", out, src], check=True)  # clean: recorded below
    record_build("nvcc:" + src, "sig", 0.0)


def not_a_compiler():
    return subprocess.run(["git", "status"], capture_output=True)  # clean: no compiler


def builds_in_loops(sources):
    libs = []
    for src in sources:
        so, _, _ = compile_library(src)  # expect: build-in-loop
        libs.append(ctypes.CDLL(str(so)))  # expect: build-in-loop
    while not libs:
        libs.append(build())  # expect: build-in-loop
    for src in sources:
        compile_library(src)  # verifylint: disable=build-in-loop
    return libs


def builds_once(sources):
    so, _, _ = compile_library(sources[0])  # clean: not in a loop
    lib = ctypes.CDLL(str(so))
    for sym in (compile_library(s) for s in sources[:0]):  # clean: a for's iter runs once
        print(sym)
    for src in sources:
        def later(s=src):
            return compile_library(s)  # clean: a def in a loop starts afresh
        print(later)
    return lib


def build():
    return None
