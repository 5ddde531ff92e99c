// Python binding of the port's CUDA kernels (module repro_torch_kernels).
//
// Each function takes device pointers and the CUDA stream as Python ints
// (tensor.data_ptr(), torch.cuda.current_stream().cuda_stream), launches
// one kernel on that stream without synchronising, and returns the CUDA
// error code of the launch (0 on success); the Python wrappers in
// repro_torch/kernels check shapes, types and devices before calling and
// raise on a non-zero code.  Only the CPython API is included here, so the
// binding compiles in about a second.

#include <Python.h>
#include <stdint.h>

extern "C" {
int repro_l0_rows(const float* x, const float* y, float* out, int64_t n,
                  int64_t d, float tol, void* stream);
int repro_l0_shift_sum(const float* x, int64_t* out,
                       unsigned long long* scratch, int64_t cap, int64_t b,
                       int64_t d, int64_t rows, int64_t width, int64_t chunk,
                       int64_t tiles, int64_t chunks, int64_t slices,
                       int64_t s_lo, int64_t n_off, int64_t q, int64_t rem,
                       int64_t stage_rows, int64_t blocks, int pack_bits,
                       float tol, void* stream);
int repro_capture_id(void* stream, unsigned long long* id);
int repro_empty(void* stream);
int repro_quantize_rows(const float* x, const float* u, const float* scale,
                        void* q, int64_t rows, int64_t d, float qmax,
                        int qbytes, void* stream);
int repro_dequantize_rows(const void* q, const float* scale, float* out,
                          int64_t rows, int64_t d, int qbytes, void* stream);
int repro_ecd_compress_rows(const float* g, const float* xh, const float* xs,
                            const float* ys, const float* u, float* x_new,
                            float* y_new, int64_t rows, int64_t d,
                            double neg_gamma, double z_keep, double y_keep,
                            float half, float two_t, float qmax,
                            void* stream);
int repro_rmsnorm(const void* x, const void* gain, void* out, int64_t n,
                  int64_t d, float eps, int dtype, void* stream);
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int64_t B, int64_t H, int64_t KV,
                          int64_t S, int64_t T, int64_t D,
                          const int64_t* strides, int causal, int64_t window,
                          float scale, int dtype, void* stream);
}

namespace {

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

PyObject* l0_rows(PyObject*, PyObject* args) {
  unsigned long long x, y, out, stream;
  long long n, d;
  float tol;
  if (!PyArg_ParseTuple(args, "KKKLLfK", &x, &y, &out, &n, &d, &tol,
                        &stream)) {
    return nullptr;
  }
  int err = repro_l0_rows(ptr<const float>(x), ptr<const float>(y),
                          ptr<float>(out), n, d, tol, ptr<void>(stream));
  return PyLong_FromLong(err);
}

// l0_shift_sum(x, out, scratch, cap, b, d, rows, width, chunk, tiles,
// chunks, slices, s_lo, n_off, q, rem, stage_rows, blocks, pack_bits, tol,
// stream): the plan's fields as kernels/csim.py ShiftPlan holds them
PyObject* l0_shift_sum(PyObject*, PyObject* args) {
  unsigned long long x, out, scratch, stream;
  long long cap, b, d, rows, width, chunk, tiles, chunks, slices, s_lo, n_off,
      q, rem, stage_rows, blocks;
  int pack_bits;
  float tol;
  if (!PyArg_ParseTuple(args, "KKKLLLLLLLLLLLLLLLifK", &x, &out, &scratch,
                        &cap, &b, &d, &rows, &width, &chunk, &tiles, &chunks,
                        &slices, &s_lo, &n_off, &q, &rem, &stage_rows,
                        &blocks, &pack_bits, &tol, &stream)) {
    return nullptr;
  }
  int err = repro_l0_shift_sum(
      ptr<const float>(x), ptr<int64_t>(out), ptr<unsigned long long>(scratch),
      cap, b, d, rows, width, chunk, tiles, chunks, slices, s_lo, n_off, q,
      rem, stage_rows, blocks, pack_bits, tol, ptr<void>(stream));
  return PyLong_FromLong(err);
}

// capture_id(stream): the id of the graph capture under way, 0 if none
PyObject* capture_id(PyObject*, PyObject* args) {
  unsigned long long stream, id = 0;
  if (!PyArg_ParseTuple(args, "K", &stream)) return nullptr;
  int err = repro_capture_id(ptr<void>(stream), &id);
  if (err != 0) {
    PyErr_Format(PyExc_RuntimeError, "cudaStreamGetCaptureInfo failed "
                 "(cudaError %d)", err);
    return nullptr;
  }
  return PyLong_FromUnsignedLongLong(id);
}

PyObject* empty(PyObject*, PyObject* args) {
  unsigned long long stream;
  if (!PyArg_ParseTuple(args, "K", &stream)) return nullptr;
  return PyLong_FromLong(repro_empty(ptr<void>(stream)));
}

PyObject* quantize_rows(PyObject*, PyObject* args) {
  unsigned long long x, u, scale, q, stream;
  long long rows, d;
  float qmax;
  int qbytes;
  if (!PyArg_ParseTuple(args, "KKKKLLfiK", &x, &u, &scale, &q, &rows, &d,
                        &qmax, &qbytes, &stream)) {
    return nullptr;
  }
  int err = repro_quantize_rows(ptr<const float>(x), ptr<const float>(u),
                                ptr<const float>(scale), ptr<void>(q), rows,
                                d, qmax, qbytes, ptr<void>(stream));
  return PyLong_FromLong(err);
}

PyObject* dequantize_rows(PyObject*, PyObject* args) {
  unsigned long long q, scale, out, stream;
  long long rows, d;
  int qbytes;
  if (!PyArg_ParseTuple(args, "KKKLLiK", &q, &scale, &out, &rows, &d,
                        &qbytes, &stream)) {
    return nullptr;
  }
  int err = repro_dequantize_rows(ptr<const void>(q), ptr<const float>(scale),
                                  ptr<float>(out), rows, d, qbytes,
                                  ptr<void>(stream));
  return PyLong_FromLong(err);
}

// ecd_compress_rows(grads, x_half, xs, ys, u, x_new, y_new, rows, d,
// neg_gamma, z_keep, y_keep, half, two_t, qmax, stream)
PyObject* ecd_compress_rows(PyObject*, PyObject* args) {
  unsigned long long g, xh, xs, ys, u, x_new, y_new, stream;
  long long rows, d;
  double neg_gamma, z_keep, y_keep;
  float half, two_t, qmax;
  if (!PyArg_ParseTuple(args, "KKKKKKKLLdddfffK", &g, &xh, &xs, &ys, &u,
                        &x_new, &y_new, &rows, &d, &neg_gamma, &z_keep,
                        &y_keep, &half, &two_t, &qmax, &stream)) {
    return nullptr;
  }
  int err = repro_ecd_compress_rows(
      ptr<const float>(g), ptr<const float>(xh), ptr<const float>(xs),
      ptr<const float>(ys), ptr<const float>(u), ptr<float>(x_new),
      ptr<float>(y_new), rows, d, neg_gamma, z_keep, y_keep, half, two_t,
      qmax, ptr<void>(stream));
  return PyLong_FromLong(err);
}

PyObject* rmsnorm(PyObject*, PyObject* args) {
  unsigned long long x, gain, out, stream;
  long long n, d;
  float eps;
  int dtype;
  if (!PyArg_ParseTuple(args, "KKKLLfiK", &x, &gain, &out, &n, &d, &eps,
                        &dtype, &stream)) {
    return nullptr;
  }
  int err = repro_rmsnorm(ptr<const void>(x), ptr<const void>(gain),
                          ptr<void>(out), n, d, eps, dtype, ptr<void>(stream));
  return PyLong_FromLong(err);
}

// flash_attention(q, k, v, out, B, H, KV, S, T, D, strides, causal, window,
// scale, dtype, stream); strides is a tuple of 12 element strides, (batch,
// head, row) of q, k, v and out in turn.
PyObject* flash_attention(PyObject*, PyObject* args) {
  unsigned long long q, k, v, out, stream;
  long long B, H, KV, S, T, D, window;
  long long st[12];
  int causal, dtype;
  float scale;
  if (!PyArg_ParseTuple(args, "KKKKLLLLLL(LLLLLLLLLLLL)iLfiK", &q, &k, &v,
                        &out, &B, &H, &KV, &S, &T, &D, &st[0], &st[1],
                        &st[2], &st[3], &st[4], &st[5], &st[6], &st[7],
                        &st[8], &st[9], &st[10], &st[11], &causal, &window,
                        &scale, &dtype, &stream)) {
    return nullptr;
  }
  int64_t strides[12];
  for (int i = 0; i < 12; ++i) strides[i] = st[i];
  int err = repro_flash_attention(ptr<const void>(q), ptr<const void>(k),
                                  ptr<const void>(v), ptr<void>(out), B, H,
                                  KV, S, T, D, strides, causal, window, scale,
                                  dtype, ptr<void>(stream));
  return PyLong_FromLong(err);
}

PyMethodDef kMethods[] = {
    {"l0_rows", l0_rows, METH_VARARGS, "K1: per-row L0 distance"},
    {"l0_shift_sum", l0_shift_sum, METH_VARARGS,
     "K2: per-batch L0 totals over cyclic shifts 1..r"},
    {"capture_id", capture_id, METH_VARARGS,
     "id of the CUDA graph capture under way on a stream, 0 if none"},
    {"empty", empty, METH_VARARGS, "an empty kernel: the launch floor"},
    {"quantize_rows", quantize_rows, METH_VARARGS,
     "K3: row-scaled stochastic quantization"},
    {"dequantize_rows", dequantize_rows, METH_VARARGS,
     "K4: row-scaled dequantization"},
    {"ecd_compress_rows", ecd_compress_rows, METH_VARARGS,
     "K3+K4 fused with ECD-PSGD's updates: one launch per step"},
    {"rmsnorm", rmsnorm, METH_VARARGS, "K5: fused RMSNorm over rows"},
    {"flash_attention", flash_attention, METH_VARARGS,
     "K6: causal / sliding-window GQA flash attention forward"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "repro_torch_kernels",
                       "CUDA kernels of repro_torch", -1, kMethods,
                       nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_repro_torch_kernels(void) {
  return PyModule_Create(&kModule);
}
