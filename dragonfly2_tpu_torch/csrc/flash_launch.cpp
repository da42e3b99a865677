// The host launcher of the flash kernels: one compiled call per launch.
//
// ops/flash.py routes a call to an instance (the routing stays in Python,
// where the tests and chip_smoke.py --threshold set it) and makes the launch
// through one function of this module per kind of launch: fwd, lse,
// partial, dkv and dq. Each takes the instance the routing chose, the
// operands, the causal flag where the kind has one, the softmax scale and
// the mma.sync instance's warps, and returns the outputs. In C++ it
// - checks what the kernels take: equal [B, H, L, D] q, k, v (and dO) of
//   one dtype, bf16 or float32 (bf16 alone for the Hopper instances), a
//   bool [B, L] key mask or None, float32 [B, H, L] lse and delta, one
//   CUDA device, contiguous operands, rows 16-byte aligned; what it refuses
//   raises ValueError or TypeError before any launch, as ops/flash.py's
//   checks on the CPU path do;
// - allocates the outputs with at::empty on q's options (the caching
//   allocator, on q's current stream);
// - enters q's device and launches the entry (csrc/flash_entries.h) on
//   that device's current stream;
// - raises RuntimeError naming the entry if the entry returns non-zero.
//
// Why compiled: done in Python around a foreign-function call, these steps
// (the checks, torch.empty for the outputs, data_ptr, the stream lookup,
// the argument conversion) cost ~40 us of host time a call at the ranker's
// trained shape on an H100's host, against a ~6 us kernel (PERF.md).
//
// A CPython extension module (METH_FASTCALL), built by ops/build.py with
// g++ against PyTorch's per-operator headers, never torch/extension.h, and
// linked to the five kernel libraries.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/csrc/Exceptions.h>
#include <torch/csrc/autograd/python_variable.h>

#include <climits>
#include <cstdint>
#include <initializer_list>
#include <string>

#include "flash_entries.h"

namespace {

// the instances, numbered as ops/flash.py numbers them
enum Instance : long { MMA_SYNC = 0, WIDE = 1, SM90 = 2, WIDE_SM90 = 3 };

const at::Tensor& tensor(PyObject* obj, const char* name) {
  TORCH_CHECK_TYPE(THPVariable_Check(obj), "flash attention takes a tensor for ", name, ", got ",
                   Py_TYPE(obj)->tp_name);
  return THPVariable_Unpack(obj);
}

// kv_mask: None for every key valid
const at::Tensor* optional_tensor(PyObject* obj, const char* name) {
  return obj == Py_None ? nullptr : &tensor(obj, name);
}

long integer(PyObject* obj) {
  const long value = PyLong_AsLong(obj);
  if (value == -1 && PyErr_Occurred()) throw python_error();
  return value;
}

int flag(PyObject* obj) {
  const int value = PyObject_IsTrue(obj);
  if (value < 0) throw python_error();
  return value;
}

float real(PyObject* obj) {
  const double value = PyFloat_AsDouble(obj);
  if (value == -1.0 && PyErr_Occurred()) throw python_error();
  return static_cast<float>(value);
}

void check_count(Py_ssize_t nargs, Py_ssize_t want, const char* kind) {
  TORCH_CHECK_TYPE(nargs == want, "the launcher's ", kind, " takes ", want, " arguments, got ",
                   nargs);
}

// q, k, v and the key mask: what ops/flash.py's _check does on the CPU path
void check_qkv(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               const at::Tensor* mask) {
  TORCH_CHECK_VALUE(q.dim() == 4 && k.sizes() == q.sizes() && v.sizes() == q.sizes(),
                    "flash attention takes equal [B, H, L, D] q/k/v, got ", q.sizes(), " ",
                    k.sizes(), " ", v.sizes());
  const auto dtype = q.scalar_type();
  TORCH_CHECK_TYPE((dtype == at::kBFloat16 || dtype == at::kFloat) && k.scalar_type() == dtype &&
                       v.scalar_type() == dtype,
                   "flash attention takes bf16 or float32 q/k/v of one dtype, got ", dtype, " ",
                   k.scalar_type(), " ", v.scalar_type());
  if (mask != nullptr) {
    TORCH_CHECK_VALUE(mask->scalar_type() == at::kBool && mask->dim() == 2 &&
                          mask->size(0) == q.size(0) && mask->size(1) == q.size(2),
                      "kv_mask must be bool [", q.size(0), ", ", q.size(2), "], got ",
                      mask->scalar_type(), " ", mask->sizes());
  }
  TORCH_CHECK_VALUE(q.is_cuda(), "the flash kernels take CUDA tensors, not ", q.device());
  for (const at::Tensor* t : {&k, &v, mask}) {
    TORCH_CHECK_VALUE(t == nullptr || t->device() == q.device(),
                      "flash attention operands must share one device");
  }
  for (const at::Tensor* t : {&q, &k, &v, mask}) {
    TORCH_CHECK_VALUE(t == nullptr || t->is_contiguous(),
                      "flash attention operands must be contiguous");
  }
  for (int i = 0; i < 4; ++i) {
    TORCH_CHECK_VALUE(q.size(i) <= INT_MAX, "flash attention takes dims below 2^31, got ",
                      q.sizes());
  }
}

// the backward's dO, lse and delta
void check_backward(const at::Tensor& q, const at::Tensor& dout, const at::Tensor& lse,
                    const at::Tensor& delta) {
  TORCH_CHECK_VALUE(dout.sizes() == q.sizes() && dout.scalar_type() == q.scalar_type(),
                    "dO must match q's shape and dtype, got ", dout.sizes(), " ",
                    dout.scalar_type());
  for (const at::Tensor* t : {&lse, &delta}) {
    TORCH_CHECK_VALUE(t->scalar_type() == at::kFloat && t->sizes() == q.sizes().slice(0, 3),
                      "lse and delta must be float32 ", q.sizes().slice(0, 3), ", got ",
                      t->scalar_type(), " ", t->sizes());
  }
  for (const at::Tensor* t : {&dout, &lse, &delta}) {
    TORCH_CHECK_VALUE(t->device() == q.device(), "flash attention operands must share one device");
    TORCH_CHECK_VALUE(t->is_contiguous(), "flash attention operands must be contiguous");
  }
}

// the kernels load [B, H, L, D] rows as 16-byte vectors (TMA too)
void check_aligned(std::initializer_list<const at::Tensor*> rows) {
  for (const at::Tensor* t : rows) {
    TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(t->const_data_ptr()) % 16 == 0,
                      "flash attention operands must be 16-byte aligned");
  }
}

void check_instance(long instance, const at::Tensor& q) {
  TORCH_CHECK_VALUE(instance >= MMA_SYNC && instance <= WIDE_SM90, "no flash instance ", instance);
  TORCH_CHECK_TYPE(instance < SM90 || q.scalar_type() == at::kBFloat16,
                   "the Hopper instances take bf16, not ", q.scalar_type());
}

void check_launched(int err, const char* entry) {
  if (err == 0) return;
  const std::string why = err >= DFLY_TMAP_ERROR
      ? "cuTensorMapEncodeTiled refused a TMA descriptor (CUresult " +
            std::to_string(err - DFLY_TMAP_ERROR) + ")"
      : std::string(cudaGetErrorString(static_cast<cudaError_t>(err)));
  TORCH_CHECK(false, entry, " launch failed: ", why, " (", err, ")");
}

const void* in(const at::Tensor& t) { return t.const_data_ptr(); }
const void* in(const at::Tensor* t) { return t == nullptr ? nullptr : t->const_data_ptr(); }
void* out(at::Tensor& t) { return t.mutable_data_ptr(); }

struct Launch {
  int B, H, L, D, dtype;  // dtype: 0 = bf16, 1 = float32
  void* stream;
};

// q's dims and dtype code and its device's current stream, with q's device
// entered by the caller's guard
Launch launch_of(const at::Tensor& q) {
  return {static_cast<int>(q.size(0)), static_cast<int>(q.size(1)), static_cast<int>(q.size(2)),
          static_cast<int>(q.size(3)), q.scalar_type() == at::kBFloat16 ? 0 : 1,
          c10::cuda::getCurrentCUDAStream(q.device().index()).stream()};
}

// the outputs as Python objects: one tensor alone, several as a tuple
PyObject* to_python(std::initializer_list<at::Tensor> outputs) {
  if (outputs.size() == 1) return THPVariable_Wrap(*outputs.begin());
  PyObject* tuple = PyTuple_New(static_cast<Py_ssize_t>(outputs.size()));
  if (tuple == nullptr) throw python_error();
  Py_ssize_t i = 0;
  for (const at::Tensor& t : outputs) {
    PyObject* item = THPVariable_Wrap(t);
    if (item == nullptr) {
      Py_DECREF(tuple);
      throw python_error();
    }
    PyTuple_SET_ITEM(tuple, i++, item);
  }
  return tuple;
}

// fwd and lse: (instance, q, k, v, kv_mask, causal, scale, warps) -> o, or (o, lse)
template <bool kLse>
PyObject* forward(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  check_count(nargs, 8, kLse ? "lse" : "fwd");
  const long instance = integer(args[0]);
  const at::Tensor& q = tensor(args[1], "q");
  const at::Tensor& k = tensor(args[2], "k");
  const at::Tensor& v = tensor(args[3], "v");
  const at::Tensor* mask = optional_tensor(args[4], "kv_mask");
  const int causal = flag(args[5]);
  const float scale = real(args[6]);
  const int warps = static_cast<int>(integer(args[7]));
  check_qkv(q, k, v, mask);
  check_aligned({&q, &k, &v});
  check_instance(instance, q);
  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor o = at::empty(q.sizes(), q.options());
  at::Tensor lse;
  if (kLse) lse = at::empty(q.sizes().slice(0, 3), q.options().dtype(at::kFloat));
  if (q.numel() > 0) {
    const Launch a = launch_of(q);
    void* lse_out = kLse ? out(lse) : nullptr;
    switch (instance) {
      case MMA_SYNC:
        check_launched(
            kLse ? dfly_flash_fwd_lse(in(q), in(k), in(v), in(mask), out(o), lse_out, a.B, a.H,
                                      a.L, a.D, causal, a.dtype, warps, scale, a.stream)
                 : dfly_flash_fwd(in(q), in(k), in(v), in(mask), out(o), a.B, a.H, a.L, a.D,
                                  causal, a.dtype, warps, scale, a.stream),
            kLse ? "dfly_flash_fwd_lse" : "dfly_flash_fwd");
        break;
      case WIDE:
        check_launched(
            kLse ? dfly_flash_fwd_lse_wide(in(q), in(k), in(v), in(mask), out(o), lse_out, a.B,
                                           a.H, a.L, a.D, causal, a.dtype, scale, a.stream)
                 : dfly_flash_fwd_wide(in(q), in(k), in(v), in(mask), out(o), a.B, a.H, a.L,
                                       a.D, causal, a.dtype, scale, a.stream),
            kLse ? "dfly_flash_fwd_lse_wide" : "dfly_flash_fwd_wide");
        break;
      case SM90:
        check_launched(
            kLse ? dfly_flash_fwd_lse_sm90(in(q), in(k), in(v), in(mask), out(o), lse_out, a.B,
                                           a.H, a.L, a.D, causal, scale, a.stream)
                 : dfly_flash_fwd_sm90(in(q), in(k), in(v), in(mask), out(o), a.B, a.H, a.L,
                                       a.D, causal, scale, a.stream),
            kLse ? "dfly_flash_fwd_lse_sm90" : "dfly_flash_fwd_sm90");
        break;
      case WIDE_SM90:
        check_launched(
            kLse ? dfly_flash_fwd_lse_wide_sm90(in(q), in(k), in(v), in(mask), out(o), lse_out,
                                                a.B, a.H, a.L, a.D, causal, scale, a.stream)
                 : dfly_flash_fwd_wide_sm90(in(q), in(k), in(v), in(mask), out(o), a.B, a.H,
                                            a.L, a.D, causal, scale, a.stream),
            kLse ? "dfly_flash_fwd_lse_wide_sm90" : "dfly_flash_fwd_wide_sm90");
        break;
    }
  }
  return kLse ? to_python({o, lse}) : to_python({o});
  END_HANDLE_TH_ERRORS
}

// partial: (instance, q, k, v, kv_mask, scale, warps) -> (acc, row_max, row_sum)
PyObject* partial(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  check_count(nargs, 7, "partial");
  const long instance = integer(args[0]);
  const at::Tensor& q = tensor(args[1], "q");
  const at::Tensor& k = tensor(args[2], "k");
  const at::Tensor& v = tensor(args[3], "v");
  const at::Tensor* mask = optional_tensor(args[4], "kv_mask");
  const float scale = real(args[5]);
  const int warps = static_cast<int>(integer(args[6]));
  check_qkv(q, k, v, mask);
  check_aligned({&q, &k, &v});
  check_instance(instance, q);
  const c10::cuda::CUDAGuard guard(q.device());
  const auto stats = q.options().dtype(at::kFloat);
  at::Tensor acc = at::empty(q.sizes(), stats);
  at::Tensor row_max = at::empty(q.sizes().slice(0, 3), stats);
  at::Tensor row_sum = at::empty(q.sizes().slice(0, 3), stats);
  if (q.numel() > 0) {
    const Launch a = launch_of(q);
    switch (instance) {
      case MMA_SYNC:
        check_launched(dfly_flash_fwd_partial(in(q), in(k), in(v), in(mask), out(acc),
                                              out(row_max), out(row_sum), a.B, a.H, a.L, a.D,
                                              a.dtype, warps, scale, a.stream),
                       "dfly_flash_fwd_partial");
        break;
      case WIDE:
        check_launched(dfly_flash_fwd_partial_wide(in(q), in(k), in(v), in(mask), out(acc),
                                                   out(row_max), out(row_sum), a.B, a.H, a.L,
                                                   a.D, a.dtype, scale, a.stream),
                       "dfly_flash_fwd_partial_wide");
        break;
      case SM90:
        check_launched(dfly_flash_fwd_partial_sm90(in(q), in(k), in(v), in(mask), out(acc),
                                                   out(row_max), out(row_sum), a.B, a.H, a.L,
                                                   a.D, scale, a.stream),
                       "dfly_flash_fwd_partial_sm90");
        break;
      case WIDE_SM90:
        check_launched(dfly_flash_fwd_partial_wide_sm90(in(q), in(k), in(v), in(mask), out(acc),
                                                        out(row_max), out(row_sum), a.B, a.H,
                                                        a.L, a.D, scale, a.stream),
                       "dfly_flash_fwd_partial_wide_sm90");
        break;
    }
  }
  return to_python({acc, row_max, row_sum});
  END_HANDLE_TH_ERRORS
}

// dkv and dq: (instance, q, k, v, dout, lse, delta, kv_mask, causal, scale,
// warps) -> (dk, dv), or dq
template <bool kDkv>
PyObject* backward(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  check_count(nargs, 11, kDkv ? "dkv" : "dq");
  const long instance = integer(args[0]);
  const at::Tensor& q = tensor(args[1], "q");
  const at::Tensor& k = tensor(args[2], "k");
  const at::Tensor& v = tensor(args[3], "v");
  const at::Tensor& dout = tensor(args[4], "dO");
  const at::Tensor& lse = tensor(args[5], "lse");
  const at::Tensor& delta = tensor(args[6], "delta");
  const at::Tensor* mask = optional_tensor(args[7], "kv_mask");
  const int causal = flag(args[8]);
  const float scale = real(args[9]);
  const int warps = static_cast<int>(integer(args[10]));
  check_qkv(q, k, v, mask);
  check_backward(q, dout, lse, delta);
  check_aligned({&q, &k, &v, &dout});
  check_instance(instance, q);
  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor first = at::empty(q.sizes(), q.options());  // dk, or dq
  at::Tensor dv;
  if (kDkv) dv = at::empty(q.sizes(), q.options());
  if (q.numel() > 0) {
    const Launch a = launch_of(q);
    switch (instance) {
      case MMA_SYNC:
        check_launched(
            kDkv ? dfly_flash_bwd_dkv(in(q), in(k), in(v), in(dout), in(lse), in(delta), in(mask),
                                      out(first), out(dv), a.B, a.H, a.L, a.D, causal, a.dtype,
                                      warps, scale, a.stream)
                 : dfly_flash_bwd_dq(in(q), in(k), in(v), in(dout), in(lse), in(delta), in(mask),
                                     out(first), a.B, a.H, a.L, a.D, causal, a.dtype, warps,
                                     scale, a.stream),
            kDkv ? "dfly_flash_bwd_dkv" : "dfly_flash_bwd_dq");
        break;
      case WIDE:
        check_launched(
            kDkv ? dfly_flash_bwd_dkv_wide(in(q), in(k), in(v), in(dout), in(lse), in(delta),
                                           in(mask), out(first), out(dv), a.B, a.H, a.L, a.D,
                                           causal, a.dtype, scale, a.stream)
                 : dfly_flash_bwd_dq_wide(in(q), in(k), in(v), in(dout), in(lse), in(delta),
                                          in(mask), out(first), a.B, a.H, a.L, a.D, causal,
                                          a.dtype, scale, a.stream),
            kDkv ? "dfly_flash_bwd_dkv_wide" : "dfly_flash_bwd_dq_wide");
        break;
      case SM90:
        check_launched(
            kDkv ? dfly_flash_bwd_dkv_sm90(in(q), in(k), in(v), in(dout), in(lse), in(delta),
                                           in(mask), out(first), out(dv), a.B, a.H, a.L, a.D,
                                           causal, scale, a.stream)
                 : dfly_flash_bwd_dq_sm90(in(q), in(k), in(v), in(dout), in(lse), in(delta),
                                          in(mask), out(first), a.B, a.H, a.L, a.D, causal, scale,
                                          a.stream),
            kDkv ? "dfly_flash_bwd_dkv_sm90" : "dfly_flash_bwd_dq_sm90");
        break;
      case WIDE_SM90:
        check_launched(
            kDkv ? dfly_flash_bwd_dkv_wide_sm90(in(q), in(k), in(v), in(dout), in(lse), in(delta),
                                                in(mask), out(first), out(dv), a.B, a.H, a.L, a.D,
                                                causal, scale, a.stream)
                 : dfly_flash_bwd_dq_wide_sm90(in(q), in(k), in(v), in(dout), in(lse), in(delta),
                                               in(mask), out(first), a.B, a.H, a.L, a.D, causal,
                                               scale, a.stream),
            kDkv ? "dfly_flash_bwd_dkv_wide_sm90" : "dfly_flash_bwd_dq_wide_sm90");
        break;
    }
  }
  return kDkv ? to_python({first, dv}) : to_python({first});
  END_HANDLE_TH_ERRORS
}

template <typename F>
PyCFunction method(F fn) {
  return reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(fn));
}

PyMethodDef kMethods[] = {
    {"fwd", method(&forward<false>), METH_FASTCALL, "finished-output forward"},
    {"lse", method(&forward<true>), METH_FASTCALL, "forward with lse"},
    {"partial", method(&partial), METH_FASTCALL, "forward, partial mode"},
    {"dkv", method(&backward<true>), METH_FASTCALL, "backward, dK/dV"},
    {"dq", method(&backward<false>), METH_FASTCALL, "backward, dQ"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "flash_launch",
                       "The host launcher of the flash kernels (csrc/flash_launch.cpp).", -1,
                       kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_flash_launch() { return PyModule_Create(&kModule); }
