// The attention f32 backward (3xTF32 on the tensor cores) of
// flash_attention_bwd.cu at the head_dims of multi-head latent attention,
// whose q and k have a head_dim (nope + rope) and v one of its own:
// minicpm3-4b's (96, 64), its smoke configuration's (24, 16) and
// deepseek-v2-lite's (192, 128). A translation unit of its own, so that
// these pairs build beside the square ones, in parallel; the kernel bodies
// are flash_attention_bwd.cu's.

#define FA_PAIRS(X) X(96, 64) X(24, 16) X(192, 128)
#define FA_ENTRY flash_attention_bwd_mla
#include "flash_attention_bwd.cu"
