// Train-mode BatchNorm's two ops on CUDA, and the autograd formula that
// ties them, in C++ (the schemas are defined in ops/batchnorm.py):
//
//   deadtrees::batch_norm_train(x, weight, bias, running_mean!, running_var!,
//       num_batches_tracked!, momentum, eps) -> (y, mean, invstd)
//   deadtrees::batch_norm_train_backward(dy, x, weight, mean, invstd)
//       -> (dx, dweight, dbias)
//
// The CUDA implementations check what batchnorm.cu's kernels take, plan the
// call's blocks, allocate through PyTorch's allocator and launch on the
// current stream, 2 + 2 launches a layer, counted in bn_op_launches. The
// autograd formula (for every device; the CPU implementations are the
// plain version in Python) saves x, weight, mean and invstd and calls the
// backward op. So no Python runs below a layer's call in its forward, nor
// anywhere in its backward, which autograd runs on a thread of its own,
// beside the data path's Python threads.
//
// Built by ops/_build.py with the host compiler against PyTorch's headers;
// it includes no CUDA header: the kernels' entry points and the device's
// SM count come from batchnorm.cu's library, handed over by
// bn_op_set_kernels, and the stream from c10's device interface.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/csrc/autograd/custom_function.h>
#include <torch/library.h>

#include <algorithm>
#include <cstdint>
#include <string>
#include <tuple>

extern "C" {
// Launches of bn_stats, bn_apply, bn_grad_reduce and bn_grad_apply
// (ops.LAUNCHES reads them).
long long bn_op_launches[4] = {0, 0, 0, 0};
}

namespace {

using ForwardFn = int (*)(const void*, void*, const void*, const void*, void*, void*, void*,
                          void*, void*, void*, float, float, float, float, int, int, int, int,
                          long long, long long, long long, int, void*);
using BackwardFn = int (*)(const void*, const void*, const void*, const void*, const void*,
                           void*, void*, void*, void*, float, int, int, int, int, long long,
                           long long, long long, int, void*);
using SmCountFn = int (*)(int);

ForwardFn g_forward = nullptr;
BackwardFn g_backward = nullptr;
SmCountFn g_sm_count = nullptr;

// The plan's constants (ops/batchnorm.py, bn_op_configure).
long long g_threads = 0, g_blocks_per_sm = 0, g_min_per_thread = 0, g_max_chunks = 0,
          g_max_chunk = 0;

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices] = {};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Raise as Python's ValueError (fail_value) or RuntimeError (fail), with
// no stack captured at the throw. Messages are put together without
// iostreams: code the host compiler's headers put into this library
// formats numbers into a stream with facets of the libstdc++ that the
// process loaded, which need not be the compiler's own (a crash on a
// card's machine).
[[noreturn]] void fail_value(std::string msg) { throw c10::ValueError(std::move(msg)); }

[[noreturn]] void fail(std::string msg) { throw c10::Error(std::move(msg)); }

std::string shape(c10::IntArrayRef sizes) {
  std::string s = "[";
  for (size_t i = 0; i < sizes.size(); ++i) {
    if (i > 0) s += ", ";
    s += std::to_string(sizes[i]);
  }
  return s + "]";
}

std::string described(const at::Tensor& t) {
  return shape(t.sizes()) + " " + c10::toString(t.scalar_type()) + " on " + t.device().str();
}

struct Plan {
  long long v, units, chunk, chunks;
};

// The split of x (n, c, H, W), hw = H * W, over blocks: a block reads
// `chunk` units of one channel (NCHW: 16-byte vectors, or elements) or of
// one channel vector (NHWC: pixels); `chunks` blocks a channel. A vector
// is 16 bytes where the tensors are aligned to 16 bytes and a vector stays
// inside one (n, c) plane (NCHW) or one pixel (NHWC); else an element. The
// chunks of a channel (or channel vector) are as many as give
// g_blocks_per_sm blocks per SM over all of them, but no chunk shorter
// than g_min_per_thread units a thread or longer than g_max_chunk
// elements, and at most g_max_chunks.
Plan plan(long long n, long long c, long long hw, bool nhwc, long long itemsize, bool aligned,
          long long sms) {
  long long v = 16 / itemsize;
  long long groups, units;
  if (nhwc) {
    if (!(aligned && c % v == 0)) v = 1;
    groups = c / v;
    units = n * hw;
  } else {
    if (!(aligned && hw % v == 0)) v = 1;
    groups = c;
    units = n * hw / v;
  }
  const long long want = std::min(ceil_div(g_blocks_per_sm * sms, groups), g_max_chunks);
  const long long chunks = std::max(1LL, std::min(want, units / (g_min_per_thread * g_threads)));
  const long long chunk = std::min(ceil_div(units, chunks), g_max_chunk / (nhwc ? 1 : v));
  return {v, units, chunk, ceil_div(units, chunk)};
}

// True for a channels-last x, false for NCHW; raises on any other layout,
// type or rank.
bool channels_last(const at::Tensor& x) {
  if (x.dim() != 4 || (x.scalar_type() != at::kBFloat16 && x.scalar_type() != at::kFloat)) {
    fail_value("expected a bfloat16 or float32 (N, C, H, W) tensor, got " + described(x));
  }
  if (x.is_contiguous()) return false;
  if (!x.is_contiguous(at::MemoryFormat::ChannelsLast)) {
    fail_value("x of strides " + shape(x.strides()) +
               " is neither NCHW- nor channels-last-contiguous");
  }
  return true;
}

void check_channels(const at::Tensor& x, const at::Tensor& t, const char* name) {
  if (t.scalar_type() != at::kFloat || t.dim() != 1 || t.size(0) != x.size(1) ||
      t.device() != x.device() || !t.is_contiguous()) {
    fail_value(std::string(name) + " must be a contiguous float32 (" + std::to_string(x.size(1)) +
               ",) tensor on " + x.device().str() + ", got " + described(t));
  }
}

// The kernels' geometry arguments for x, and its plan.
struct Call {
  Plan p;
  long long c, hw;
  void* stream;
};

Call prepare(const at::Tensor& x, bool nhwc, bool aligned) {
  if (g_forward == nullptr || g_backward == nullptr) {
    fail("batchnorm.cu's kernels are not loaded (ops/batchnorm.py load())");
  }
  const long long n = x.size(0), c = x.size(1), hw = x.size(2) * x.size(3);
  if (n * hw == 0) fail_value("no values to normalise in " + shape(x.sizes()));
  const int device = x.get_device();
  if (device < 0 || device >= kMaxDevices) {
    fail("device " + std::to_string(device) + " out of range");
  }
  if (g_sms[device] == 0) g_sms[device] = g_sm_count(device);
  if (g_sms[device] <= 0) fail("no SM count for device " + std::to_string(device));
  const Plan p = plan(n, c, hw, nhwc, x.element_size(), aligned, g_sms[device]);
  if (p.units >= (1LL << 31) || (!nhwc && c >= (1LL << 16))) {
    fail_value(shape(x.sizes()) + " does not fit the kernels' grid");
  }
  const c10::Stream stream =
      c10::impl::getDeviceGuardImpl(c10::DeviceType::CUDA)->getStream(x.device());
  return {p, c, hw, stream.native_handle()};
}

bool aligned16(const at::Tensor& t) {
  return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0;
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> forward_cuda(
    const at::Tensor& x, const at::Tensor& weight, const at::Tensor& bias,
    const at::Tensor& running_mean, const at::Tensor& running_var,
    const at::Tensor& num_batches_tracked, double momentum, double eps) {
  const bool nhwc = channels_last(x);
  check_channels(x, weight, "weight");
  check_channels(x, bias, "bias");
  check_channels(x, running_mean, "running_mean");
  check_channels(x, running_var, "running_var");
  if (num_batches_tracked.scalar_type() != at::kLong || num_batches_tracked.numel() != 1 ||
      num_batches_tracked.device() != x.device()) {
    fail_value("num_batches_tracked must be one int64 on x's device");
  }
  const c10::DeviceGuard guard(x.device());
  const Call k = prepare(x, nhwc, aligned16(x));
  const auto f32 = x.options().dtype(at::kFloat);
  at::Tensor y = at::empty_like(x);
  at::Tensor mean = at::empty({k.c}, f32);
  at::Tensor invstd = at::empty({k.c}, f32);
  at::Tensor part = at::empty({k.c * k.p.chunks * 3}, f32);
  const int status = g_forward(
      x.data_ptr(), part.data_ptr(), weight.data_ptr(), bias.data_ptr(),
      running_mean.data_ptr(), running_var.data_ptr(), num_batches_tracked.data_ptr(),
      mean.data_ptr(), invstd.data_ptr(), y.data_ptr(), static_cast<float>(momentum),
      static_cast<float>(1.0 - momentum), static_cast<float>(eps),
      static_cast<float>(x.numel() / k.c), x.scalar_type() == at::kBFloat16, nhwc,
      static_cast<int>(k.p.v), static_cast<int>(k.c), k.hw, k.p.units, k.p.chunk,
      static_cast<int>(k.p.chunks), k.stream);
  if (status != 0) fail("bn_forward launch failed: CUDA error " + std::to_string(status));
  __atomic_fetch_add(&bn_op_launches[0], 1, __ATOMIC_RELAXED);
  __atomic_fetch_add(&bn_op_launches[1], 1, __ATOMIC_RELAXED);
  return {y, mean, invstd};
}

// dy is brought to x's type and layout, which autograd need not hand it in.
std::tuple<at::Tensor, at::Tensor, at::Tensor> backward_cuda(
    const at::Tensor& dy_in, const at::Tensor& x, const at::Tensor& weight,
    const at::Tensor& mean, const at::Tensor& invstd) {
  const bool nhwc = channels_last(x);
  check_channels(x, weight, "weight");
  check_channels(x, mean, "mean");
  check_channels(x, invstd, "invstd");
  if (dy_in.sizes() != x.sizes() || dy_in.device() != x.device()) {
    fail_value("dy " + described(dy_in) + " does not match x " + described(x));
  }
  const at::Tensor dy = dy_in.to(x.scalar_type()).contiguous(
      nhwc ? at::MemoryFormat::ChannelsLast : at::MemoryFormat::Contiguous);
  const c10::DeviceGuard guard(x.device());
  const Call k = prepare(x, nhwc, aligned16(x) && aligned16(dy));
  const auto f32 = x.options().dtype(at::kFloat);
  at::Tensor dx = at::empty_like(x);
  at::Tensor dweight = at::empty({k.c}, f32);
  at::Tensor dbias = at::empty({k.c}, f32);
  at::Tensor part = at::empty({k.c * k.p.chunks * 2}, f32);
  const int status = g_backward(
      dy.data_ptr(), x.data_ptr(), weight.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
      part.data_ptr(), dx.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
      static_cast<float>(x.numel() / k.c), x.scalar_type() == at::kBFloat16, nhwc,
      static_cast<int>(k.p.v), static_cast<int>(k.c), k.hw, k.p.units, k.p.chunk,
      static_cast<int>(k.p.chunks), k.stream);
  if (status != 0) fail("bn_backward launch failed: CUDA error " + std::to_string(status));
  __atomic_fetch_add(&bn_op_launches[2], 1, __ATOMIC_RELAXED);
  __atomic_fetch_add(&bn_op_launches[3], 1, __ATOMIC_RELAXED);
  return {dx, dweight, dbias};
}

using torch::autograd::AutogradContext;
using torch::autograd::variable_list;

// The autograd formula: the forward op below autograd, then the backward
// op on the saved x, weight, mean and invstd. mean and invstd are outputs
// without a gradient.
struct BatchNormTrain : public torch::autograd::Function<BatchNormTrain> {
  static variable_list forward(AutogradContext* ctx, const at::Tensor& x,
                               const at::Tensor& weight, const at::Tensor& bias,
                               const at::Tensor& running_mean, const at::Tensor& running_var,
                               const at::Tensor& num_batches_tracked, double momentum,
                               double eps) {
    static const auto op = c10::Dispatcher::singleton()
                               .findSchemaOrThrow("deadtrees::batch_norm_train", "")
                               .typed<std::tuple<at::Tensor, at::Tensor, at::Tensor>(
                                   const at::Tensor&, const at::Tensor&, const at::Tensor&,
                                   const at::Tensor&, const at::Tensor&, const at::Tensor&,
                                   double, double)>();
    at::Tensor y, mean, invstd;
    {
      const at::AutoDispatchBelowADInplaceOrView below;
      std::tie(y, mean, invstd) = op.call(x, weight, bias, running_mean, running_var,
                                          num_batches_tracked, momentum, eps);
    }
    ctx->save_for_backward({x, weight, mean, invstd});
    ctx->mark_non_differentiable({mean, invstd});
    return {y, mean, invstd};
  }

  static variable_list backward(AutogradContext* ctx, variable_list grads) {
    static const auto op = c10::Dispatcher::singleton()
                               .findSchemaOrThrow("deadtrees::batch_norm_train_backward", "")
                               .typed<std::tuple<at::Tensor, at::Tensor, at::Tensor>(
                                   const at::Tensor&, const at::Tensor&, const at::Tensor&,
                                   const at::Tensor&, const at::Tensor&)>();
    const variable_list saved = ctx->get_saved_variables();
    at::Tensor dx, dweight, dbias;
    {
      const at::AutoDispatchBelowADInplaceOrView below;
      std::tie(dx, dweight, dbias) = op.call(grads[0], saved[0], saved[1], saved[2], saved[3]);
    }
    return {dx, dweight, dbias, at::Tensor(), at::Tensor(), at::Tensor(), at::Tensor(),
            at::Tensor()};
  }
};

std::tuple<at::Tensor, at::Tensor, at::Tensor> forward_autograd(
    const at::Tensor& x, const at::Tensor& weight, const at::Tensor& bias,
    const at::Tensor& running_mean, const at::Tensor& running_var,
    const at::Tensor& num_batches_tracked, double momentum, double eps) {
  const variable_list out = BatchNormTrain::apply(x, weight, bias, running_mean, running_var,
                                                  num_batches_tracked, momentum, eps);
  return {out[0], out[1], out[2]};
}

}  // namespace

extern "C" {

// The plan's constants, from ops/batchnorm.py.
void bn_op_configure(long long threads, long long blocks_per_sm, long long min_per_thread,
                     long long max_chunks, long long max_chunk) {
  g_threads = threads;
  g_blocks_per_sm = blocks_per_sm;
  g_min_per_thread = min_per_thread;
  g_max_chunks = max_chunks;
  g_max_chunk = max_chunk;
}

// batchnorm.cu's bn_forward, bn_backward and bn_sm_count.
void bn_op_set_kernels(void* forward, void* backward, void* sm_count) {
  g_forward = reinterpret_cast<ForwardFn>(forward);
  g_backward = reinterpret_cast<BackwardFn>(backward);
  g_sm_count = reinterpret_cast<SmCountFn>(sm_count);
}

// The plan of x (n, c, H, W) with hw = H * W: out = (v, units, chunk, chunks).
void bn_op_plan(long long n, long long c, long long hw, int nhwc, int itemsize, int aligned,
                int sms, long long* out) {
  const Plan p = plan(n, c, hw, nhwc != 0, itemsize, aligned != 0, sms);
  out[0] = p.v;
  out[1] = p.units;
  out[2] = p.chunk;
  out[3] = p.chunks;
}

}  // extern "C"

TORCH_LIBRARY_IMPL(deadtrees, CUDA, m) {
  m.impl("batch_norm_train", TORCH_FN(forward_cuda));
  m.impl("batch_norm_train_backward", TORCH_FN(backward_cuda));
}

TORCH_LIBRARY_IMPL(deadtrees, Autograd, m) {
  m.impl("batch_norm_train", TORCH_FN(forward_autograd));
}
