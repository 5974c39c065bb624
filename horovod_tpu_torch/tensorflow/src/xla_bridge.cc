// XLA CPU custom-call bridge for the TensorFlow adapter of
// horovod_tpu_torch.
//
// Reference parity: horovod/tensorflow/xla_mpi_ops.cc — the reference
// registers its collectives as XLA custom calls so they can live inside
// tf.function(jit_compile=True).  The C side is pure pointer plumbing:
// one custom-call target that forwards buffers to a Python callback,
// which runs the package's collectives (torch.distributed).  All shape,
// dtype and op metadata travels in a meta operand built at trace time,
// so this file needs no TF op machinery — only XLA's target registry,
// whose live instance is shared with the interpreter through
// libtensorflow_cc.so.2.
//
// The target and entry names carry "torch" so that this library and the
// JAX package's bridge can be loaded into one process without one
// registration shadowing the other.
//
// Built at first use by horovod_tpu_torch/tensorflow/xla_ops.py with the
// system g++ against the pip-shipped TF headers, into
// build/horovod_tpu_torch/; no Python headers needed (the callback
// crosses via a ctypes CFUNCTYPE pointer, which takes the GIL on entry).

#include <cstdint>

#include "xla/service/custom_call_target_registry.h"

namespace {

// Python-side callback: (meta_json, meta_len, data_in_ptrs, out_ptrs).
typedef void (*HvdTfCallback)(const void* meta, uint32_t meta_len,
                              const void** ins, void** outs);

HvdTfCallback g_callback = nullptr;

}  // namespace

extern "C" void hvd_tpu_torch_tf_set_callback(HvdTfCallback cb) {
  g_callback = cb;
}

// Custom-call entry point.  Operand 0 is the meta buffer:
//   [u32 meta_len][u32 n_results][meta_len bytes of JSON]
// operands 1..N are tensor data.  XLA hands a direct buffer pointer for a
// single result and a tuple (void**) for several; n_results from the
// header disambiguates, so Python always sees a flat out-pointer array.
extern "C" void hvd_tpu_torch_tf_collective(void* out, const void** ins) {
  const uint8_t* hdr = static_cast<const uint8_t*>(ins[0]);
  uint32_t meta_len, n_results;
  __builtin_memcpy(&meta_len, hdr, 4);
  __builtin_memcpy(&n_results, hdr + 4, 4);
  void* single[1];
  void** outs;
  if (n_results == 1) {
    single[0] = out;
    outs = single;
  } else {
    outs = static_cast<void**>(out);
  }
  g_callback(hdr + 8, meta_len, ins + 1, outs);
}

namespace {
bool registered = [] {
  xla::CustomCallTargetRegistry::Global()->Register(
      "hvd_tpu_torch_tf_collective",
      reinterpret_cast<void*>(&hvd_tpu_torch_tf_collective), "Host");
  return true;
}();
}  // namespace
