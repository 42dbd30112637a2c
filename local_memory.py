#!/usr/bin/env python3
"""Which source lines of the CUDA kernels use local memory.

Run from the repository root, on a machine with nvcc:

    python3 local_memory.py [--source FILE] [--kernel NAME]

Builds FILE (default rtc_tpu_torch/csrc/mesh_intersect.cu) to a cubin with
the port's nvcc flags and -lineinfo, which leaves the registers and the
spills as they are. For each kernel whose mangled name holds NAME (default:
every kernel), prints ptxas's registers, stack frame and spill bytes, then
each local load or store (LDL, STL) of its SASS with the source line it
came from (nvdisasm -g). Exits non-zero if the build fails.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

from rtc_tpu_torch.ops.kernels import mesh_intersect as mi

# the flags of a shared library that a cubin does not take
LIBRARY_ONLY = ("-shared", "-Xcompiler", "-fPIC")


def ptxas_report(log: str) -> dict:
    """{mangled kernel: ptxas's lines of stack, spills and registers}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("stack frame" in line or "Used" in line):
            out.setdefault(name, []).append(re.sub(r"^ptxas info\s*:\s*", "", line.strip()))
    return out


def local_accesses(disasm: str) -> dict:
    """{mangled kernel: [(source file:line, SASS instruction)]} of every LDL
    and STL in nvdisasm -g output."""
    out = {}
    for part in re.split(r"\n\s*\.section\s+\.text\.", disasm)[1:]:
        name = part.split("\n", 1)[0].split(",")[0].strip()
        where, found = None, []
        for line in part.splitlines():
            m = re.search(r'//## File "([^"]+)", line (\d+)', line)
            if m:
                where = f"{os.path.basename(m.group(1))}:{m.group(2)}"
            m = re.search(r"/\*[0-9a-f]+\*/\s+(.*?)\s*;", line)
            if m and re.search(r"\b(LDL|STL)\b", m.group(1)):
                found.append((where, m.group(1)))
        out[name] = found
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=mi.SOURCE)
    ap.add_argument("--kernel", default="", help="a part of the kernels' mangled names")
    args = ap.parse_args()
    flags = [f for f in mi.NVCC_FLAGS if f not in LIBRARY_ONLY]
    bin_dir = os.path.dirname(mi.find_nvcc())
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "kernels.cubin")
        proc = subprocess.run([mi.find_nvcc(), *flags, "-lineinfo", "-cubin", "-o", cubin,
                               args.source], capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"nvcc failed on {args.source}:\n{proc.stderr}", file=sys.stderr)
            return 1
        disasm = subprocess.run([os.path.join(bin_dir, "nvdisasm"), "-g", "-c", cubin],
                                capture_output=True, text=True, check=True).stdout
    report, access = ptxas_report(proc.stdout + proc.stderr), local_accesses(disasm)
    for name in sorted(report):
        if args.kernel not in name:
            continue
        print(name)
        for line in report[name]:
            print("  ptxas:", line)
        for where, instr in access.get(name, []):
            print(f"  {where}: {instr}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
