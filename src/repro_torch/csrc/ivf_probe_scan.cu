// IVF probe scan, SQ8 and fp32 lists.
//
// Replaces: src/repro/kernels/gather_scan.py:ivf_probe_scan
//   (_ivf_scan_sq8_kernel, _ivf_scan_fp_kernel), a scalar-prefetch Pallas
//   kernel with grid (B, nprobe) that DMAs cluster probe[b, p]'s (cap, d')
//   list into VMEM and scores it on the MXU.
//
// Bound on the H100: device-memory bytes, the distinct live rows' (0.49 ms
// at the served shape), below the exact widening's instructions (0.66 ms).
// The design (the (b, p) pairs grouped by list, each live row staged once
// for a chunk of up to 8 of its readers) is the shared scan body's:
// scan_grouped.cuh, which query_fused.cu runs too, so a row scores the same
// bits on both routes.  Three CUDA launches a call: the grouping's memset,
// the grouping, the scan.
#include "scan_grouped.cuh"

// The work items' shape, for the callers' reports: {queries, slots} an item.
extern "C" void ivf_probe_scan_item(int* shape) {
  shape[0] = kScanQ;
  shape[1] = kScanRange;
}

extern "C" int ivf_probe_scan_sq8(const void* q, const void* probe, const void* ids,
                                  const void* codes, const void* scales, void* out,
                                  void* scratch, int B, int P, int cap, int D, int nlist,
                                  void* stream) {
  return launch_ivf_scan<int8_t>((const float*)q, (const int*)probe, (const int*)ids,
                                 (const int8_t*)codes, (const float*)scales, (float*)out,
                                 (int*)scratch, B, P, cap, D, nlist, (cudaStream_t)stream);
}

extern "C" int ivf_probe_scan_fp32(const void* q, const void* probe, const void* ids,
                                   const void* vecs, void* out, void* scratch, int B, int P,
                                   int cap, int D, int nlist, void* stream) {
  return launch_ivf_scan<float>((const float*)q, (const int*)probe, (const int*)ids,
                                (const float*)vecs, nullptr, (float*)out, (int*)scratch, B, P,
                                cap, D, nlist, (cudaStream_t)stream);
}
