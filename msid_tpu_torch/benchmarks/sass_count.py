"""Static instruction counts of a kernel source's SASS, per ``__global__``
function and per loop, from ``cuobjdump -sass``.

    python -m msid_tpu_torch.benchmarks.sass_count noise [--define MSID_C=48]

Builds ``csrc/<name>.cu`` for sm_90a with the port's compiler flags and
prints one JSON line: for each function (demangled name), its instruction
count, the count of every opcode (``op <OPCODE>``, modifiers dropped) and
of a few opcodes with their modifiers (``IMAD.WIDE``, ``LOP3``, ``MUFU``,
loads and stores, branches, ``HGMMA``), and its loops. A whole function's
count includes code that runs once per thread or rarely (set-up, the slow
paths of ``logf`` and ``sqrtf`` the compiler places out of line), so it
says little of what a thread issues per element; a loop's count, from the
target of a backward branch to the branch, is what one pass of that loop
issues on its usual path (``chip_smoke.py`` reads K2's element loop so, from
the library it built). Needs ``nvcc`` and ``cuobjdump``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

from msid_tpu_torch.ops._build import CSRC, NVCC_FLAGS, nvcc_path

OPCODES = ("IMAD.WIDE", "LOP3", "MUFU", "LDG", "STG", "LDS", "STS", "BRA", "HGMMA", "FFMA")
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_ADDRESS = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def sass(name: str, defines: tuple[str, ...] = ()) -> str:
    """The SASS listing of ``csrc/<name>.cu`` built with the port's flags."""
    nvcc = nvcc_path()
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / f"{name}.cubin"
        subprocess.run([nvcc, *flags, *(f"-D{d}" for d in defines), "-cubin", "-o", str(cubin),
                        str(CSRC / f"{name}.cu")], check=True, capture_output=True, text=True)
        return sass_of(cubin)


def sass_of(binary: Path) -> str:
    """The SASS listing of a cubin or of a library that embeds one."""
    cuobjdump = str(Path(nvcc_path()).parent / "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(binary)], check=True,
                          capture_output=True, text=True).stdout


def demangle(names: list[str]) -> list[str]:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
        return out if len(out) == len(names) else names
    except (OSError, subprocess.CalledProcessError):
        return names


def count(listing: str) -> dict:
    """Per function: instructions in all, and per opcode of ``OPCODES``."""
    functions: dict[str, Counter] = {}
    current = None
    for line in listing.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = functions.setdefault(m.group(1), Counter())
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None and m.group(1) != "NOP":
            op = m.group(1)
            current["instructions"] += 1
            current["op " + op.split(".")[0]] += 1
            for prefix in OPCODES:
                if op.startswith(prefix):
                    current[prefix] += 1
    names = list(functions)
    return {pretty: dict(functions[raw]) for raw, pretty in zip(names, demangle(names))}


def loops(listing: str) -> dict:
    """Per function (demangled), its loops: for each backward branch, the
    instructions from its target to the branch itself (one pass; a nested
    loop's body counted once), and the global loads and stores and shared
    loads among them, ordered by where the loop starts."""
    bodies: dict[str, list] = {}
    targets: dict[str, dict] = {}
    body, pending = None, []
    for line in listing.splitlines():
        m = _FUNCTION.match(line)
        if m:
            body, pending = bodies.setdefault(m.group(1), []), []
            labels = targets.setdefault(m.group(1), {})
            continue
        m = _LABEL.match(line)
        if m and body is not None:
            pending.append(m.group(1))
            continue
        m = _INSTRUCTION.match(line)
        if m and body is not None and m.group(1) != "NOP":
            address = int(_ADDRESS.match(line).group(1), 16)
            labels.update((label, address) for label in pending)
            pending = []
            text = line.split("*/", 1)[1].split(";")[0].strip()
            body.append((address, text[text.index(m.group(1)):]))
    found = {}
    for name, body in bodies.items():
        found[name] = []
        for at, (address, text) in enumerate(body):
            m = _TARGET.search(text) if text.startswith("BRA") else None
            target = m and (targets[name].get(m.group(1)) if m.group(1)
                            else int(m.group(2), 16))
            if target is None or target > address:
                continue
            ops = [op.split()[0] for a, op in body[:at + 1] if a >= target]
            found[name].append({"start": target, "end": address, "instructions": len(ops),
                                **{k: sum(op.startswith(k) for op in ops)
                                   for k in ("LDG", "STG", "LDS")}})
        found[name].sort(key=lambda loop: loop["start"])
    names = list(found)
    return {pretty: found[raw] for raw, pretty in zip(names, demangle(names))}


def element_loops(function_loops: list) -> dict:
    """The element loops of a kernel that has one for the gated samples and
    one for the rest: the outermost loops that load and store global
    memory, exactly two, the gated one reading more of shared memory (the
    stripes). Returns ``{"gated": loop, "plain": loop}``; raises
    ``ValueError`` when the SASS does not hold that shape."""
    io = [lp for lp in function_loops if lp["LDG"] and lp["STG"]]
    outer = [lp for lp in io if not any(o is not lp and o["start"] <= lp["start"]
                                       and lp["end"] <= o["end"] for o in io)]
    if len(outer) != 2 or outer[0]["LDS"] == outer[1]["LDS"]:
        raise ValueError(f"expected two element loops told apart by their shared loads, "
                         f"got {outer}")
    plain, gated = sorted(outer, key=lambda lp: lp["LDS"])
    return {"gated": gated, "plain": plain}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("name", help="csrc/<name>.cu")
    parser.add_argument("--define", action="append", default=[], help="-D define, repeatable")
    args = parser.parse_args(argv)
    listing = sass(args.name, tuple(args.define))
    result = {"source": f"msid_tpu_torch/csrc/{args.name}.cu", "defines": args.define,
              "functions": count(listing), "loops": loops(listing)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
