// K7 v2, the pipelined body (infodiffusion_tpu/ops/pallas/qconv.py
// _kernel_v2): K7 with the raw pieces staged into shared memory by bulk
// copies a fill ahead of the chain. What bounds K7 and the design: qconv.cu.
#include "qconv_wgmma.cuh"

// K7 v2: arguments and result as infodiff_qconv (qconv.cu), bitwise; the
// plan is qconv_launch_plan's for the pipelined body.
INFODIFF_EXPORT int infodiff_qconv_v2(
    const void* x0, const void* x1, int C0, int C1, int dtype,
    const float* A, const float* Bv, const float* s_act, const void* w,
    const float* scale, const float* bias, void* out, int out_code, int B,
    int H, int W, int Cout, int ipt, int th, int tw, int ring, int raw_rows,
    int stages, int smem, int blocks, cudaStream_t stream) {
  return qconv_wgmma::qconv_entry<true>(
      x0, x1, C0, C1, dtype, A, Bv, s_act, w, scale, bias, out, out_code, B,
      H, W, Cout, ipt, th, tw, ring, raw_rows, stages, smem, blocks, stream);
}
