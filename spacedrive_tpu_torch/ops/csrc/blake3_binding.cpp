// PyTorch binding for the BLAKE3 chunk kernel (blake3_chunk.cu).
//
// The only source of the extension that includes torch/extension.h: the
// kernel file keeps a plain C++ interface so nvcc never parses PyTorch's
// headers. This file checks the tensors, allocates the output, launches
// on the current stream of the tensors' device, and checks the launch.

#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

void sd_blake3_chunk_cvs_launch(const void* words, const void* chunk_len,
                                const void* is_root, const void* t_lo, void* out,
                                int64_t n, cudaStream_t stream);

namespace {

void check_lane_vector(const torch::Tensor& t, const char* name, int64_t n,
                       const torch::Device& device) {
  TORCH_CHECK(t.device() == device, name, " must be on ", device, ", got ", t.device());
  TORCH_CHECK(t.scalar_type() == torch::kInt32, name, " must be int32, got ", t.scalar_type());
  TORCH_CHECK(t.dim() == 1 && t.size(0) == n, name, " must have shape [", n, "], got ",
              t.sizes());
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

// words int32 [N, 256] (the LE message words of N chunk lanes);
// chunk_len / is_root / t_lo int32 [N]  ->  chaining values int32 [8, N].
torch::Tensor chunk_cvs(const torch::Tensor& words, const torch::Tensor& chunk_len,
                        const torch::Tensor& is_root, const torch::Tensor& t_lo) {
  TORCH_CHECK(words.is_cuda(), "words must be a CUDA tensor");
  TORCH_CHECK(words.scalar_type() == torch::kInt32, "words must be int32, got ",
              words.scalar_type());
  TORCH_CHECK(words.dim() == 2 && words.size(1) == 256, "words must have shape [N, 256], got ",
              words.sizes());
  TORCH_CHECK(words.is_contiguous(), "words must be contiguous");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(words.data_ptr()) % 16 == 0,
              "words must be 16-byte aligned");
  const int64_t n = words.size(0);
  TORCH_CHECK(n > 0, "words must hold at least one lane");
  check_lane_vector(chunk_len, "chunk_len", n, words.device());
  check_lane_vector(is_root, "is_root", n, words.device());
  check_lane_vector(t_lo, "t_lo", n, words.device());

  const c10::cuda::CUDAGuard guard(words.device());
  auto out = torch::empty({8, n}, words.options());
  sd_blake3_chunk_cvs_launch(words.data_ptr(), chunk_len.data_ptr(), is_root.data_ptr(),
                             t_lo.data_ptr(), out.data_ptr(), n,
                             c10::cuda::getCurrentCUDAStream(words.get_device()).stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("chunk_cvs", &chunk_cvs, "BLAKE3 chunk chaining values (CUDA, sm_90a)");
}
