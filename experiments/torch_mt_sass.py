"""SASS instructions of one Moller-Trumbore (MT) pair as the port's kernels
compile it, and the FP32 ceiling that count sets.

    python experiments/torch_mt_sass.py

Compiles ``tpupt_torch/accel/csrc/treelet_kernels.cu`` with the kernels'
own flags (``--fmad=false``, no fast math) into a cubin together with
probe kernels that fold N = 4 and N = 8 pairs of one ray with the
strict-`<` winner fold and the pair's live mask, once through ``mt_t``
(one pair at a time: the closest-hit walk's routine) and once through
``mt_ok4`` (four at a time: the any-hit walk's and winner_step's), and
reads the SASS with ``cuobjdump -sass``.  The marginal count,
(count(8) - count(4)) / 4, is what one more pair costs, by opcode class.
With one warp instruction issued per scheduler and clock, an SM runs 128
lane instructions a clock while the published FP32 peak counts 256
operations a clock (an FMA as two), so a kernel whose pair costs n
instructions can reach at most 56 / (2 n) of the 56-operation bound.
Also prints ``-Xptxas -v``'s registers and shared memory of every kernel.
With ``--compare-root DIR`` (another checkout, e.g. the parent commit's
``git archive`` under ``build/parent``) it also compiles DIR's kernels and
says whether each closest-hit kernel's SASS (the instructions, addresses
stripped) is the same in both.  The last line of standard output is one
JSON object.  Needs nvcc and cuobjdump; no card.

    python experiments/torch_mt_sass.py [--compare-root build/parent]
"""

import argparse
import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpupt_torch.accel import kernels  # noqa: E402

PROBE = r"""
#include "treelet_kernels.cu"

namespace {
template <int N>
__device__ __forceinline__ void mt_probe(const float* __restrict__ in, float* __restrict__ out) {
  const int i = threadIdx.x;
  const Ray r{in[i], in[i + 32], in[i + 64], in[i + 96], in[i + 128], in[i + 160], in[i + 192]};
  const float tcap = in[i + 224];
  float best = kBig;
  int jw = -1;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float* c = in + 256 + 10 * j;
    const float tj = mt_t(r, tcap, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8]);
    if (c[9] > 0.0f && tj < best) {
      best = tj;
      jw = j;
    }
  }
  out[i] = best;
  reinterpret_cast<int*>(out)[i + 32] = jw;
}

// the same fold through mt_ok4, four pairs a group
template <int N>
__device__ __forceinline__ void mt4_probe(const float* __restrict__ in, float* __restrict__ out) {
  const int i = threadIdx.x;
  const Ray r{in[i], in[i + 32], in[i + 64], in[i + 96], in[i + 128], in[i + 160], in[i + 192]};
  const float tcap = in[i + 224];
  float best = kBig;
  int jw = -1;
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4* c = reinterpret_cast<const float4*>(in + 256 + 40 * j);
    float4 q[9];
#pragma unroll
    for (int m = 0; m < 9; ++m) q[m] = c[m];
    const float4 lq = c[9];
    bool ok[4];
    float t[4];
    mt_ok4(r, tcap, q, ok, t);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (lane_of(lq, m) > 0.0f && ok[m] && t[m] < best) {
        best = t[m];
        jw = j + m;
      }
    }
  }
  out[i] = best;
  reinterpret_cast<int*>(out)[i + 32] = jw;
}
}  // namespace

extern "C" __global__ void mt_probe4(const float* in, float* out) { mt_probe<4>(in, out); }
extern "C" __global__ void mt_probe8(const float* in, float* out) { mt_probe<8>(in, out); }
extern "C" __global__ void mt4_probe4(const float* in, float* out) { mt4_probe<4>(in, out); }
extern "C" __global__ void mt4_probe8(const float* in, float* out) { mt4_probe<8>(in, out); }
"""

FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK", "MUFU", "FSET"}
MEM = {"LDG", "LDS", "LDC", "ULDC", "STG", "STS", "LD", "ST"}
CTRL = {"BRA", "CALL", "RET", "BSSY", "BSYNC", "EXIT", "NOP", "WARPSYNC", "BAR"}


def classify(op):
    if op in FP32:
        return "fp32"
    if op in MEM:
        return "memory"
    if op in CTRL:
        return "control"
    return "integer/predicate"


def sass_listing(cubin):
    """{function: [instruction text without address or encoding]}."""
    out = subprocess.run([os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump"), "-sass",
                          cubin], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and name:
            funcs[name].append(m.group(1))
    return funcs


def sass_by_function(cubin):
    funcs = {}
    for name, instrs in sass_listing(cubin).items():
        ops = (re.match(r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", i) for i in instrs)
        funcs[name] = collections.Counter(m.group(1) for m in ops if m)
    return funcs


def compile_cubin(src, cubin, include):
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([kernels._nvcc(), *flags, "-cubin", "-I", include, src, "-o", cubin],
                          capture_output=True, text=True, check=True)
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "Compiling entry" in ln]


def closest_hit_sass(cubin):
    """The two closest-hit kernels' SASS, by template argument."""
    out = {}
    for name, instrs in sass_listing(cubin).items():
        for form, tag in (("6-channel", "treelet_closest_hit_kernelILb0E"),
                          ("payload", "treelet_closest_hit_kernelILb1E")):
            if tag in name:
                out[form] = instrs
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare-root", default=None)
    args = ap.parse_args()
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(kernels.BUILD_DIR, "mt_probe.cu")
    with open(src, "w") as fh:
        fh.write(PROBE)
    cubin = os.path.join(kernels.BUILD_DIR, "mt_probe.cubin")
    ptxas = compile_cubin(src, cubin, kernels._CSRC)
    print("\n".join(ptxas))
    funcs = sass_by_function(cubin)
    report = dict(kernel_sass_instructions={k: sum(v.values()) for k, v in funcs.items()},
                  ptxas=ptxas)
    for label, probe in (("mt_t", "mt_probe"), ("mt_ok4", "mt4_probe")):
        c4, c8 = funcs[f"{probe}4"], funcs[f"{probe}8"]
        marginal = {op: (c8[op] - c4[op]) / 4 for op in set(c4) | set(c8) if c8[op] != c4[op]}
        by_class = collections.Counter()
        for op, v in marginal.items():
            by_class[classify(op)] += v
        total = sum(marginal.values())
        alu = total - by_class["memory"]
        report[label] = dict(
            marginal_per_pair=dict(sorted(marginal.items())), by_class=dict(by_class),
            instructions_per_pair=total, alu_instructions_per_pair=alu,
            ceiling_share_of_fp32_bound=56 / (2 * alu))
        print(f"one MT pair with the fold through {label}: {total:g} SASS instructions ({alu:g} "
              f"outside memory); by class {dict(by_class)}")
        print(f"  by opcode {report[label]['marginal_per_pair']}")
        print(f"  ceiling: 56 / (2 x {alu:g}) = {56 / (2 * alu):.1%} of the FP32 bound when the "
              "pair's operands come from registers or shared memory at no issue cost")
    if args.compare_root:
        other = os.path.join(kernels.BUILD_DIR, "compare.cubin")
        other_src = os.path.join(os.path.abspath(args.compare_root), "tpupt_torch", "accel", "csrc",
                                 "treelet_kernels.cu")
        compile_cubin(other_src, other, os.path.dirname(other_src))
        mine, theirs = closest_hit_sass(cubin), closest_hit_sass(other)
        assert mine.keys() == theirs.keys() == {"6-channel", "payload"}, (mine.keys(), theirs.keys())
        same = {form: mine[form] == theirs[form] for form in mine}
        report["closest_hit_sass_same_as"] = dict(root=args.compare_root, same=same,
                                                  instructions={f: len(v) for f, v in mine.items()})
        print(f"closest-hit SASS equal to {args.compare_root}'s: {same} "
              f"({ {f: len(v) for f, v in mine.items()} } instructions)")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
