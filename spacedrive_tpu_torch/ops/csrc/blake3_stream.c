/* Streaming BLAKE3 (hash mode) on the host, in portable C: the
 * validator's full-file checksum for files the device leg does not take
 * (empty files, files over 256 KiB, buckets too small to batch), and the
 * one-shot digest of crypto/hashing.py's Balloon hashing.
 *
 * An owned copy of the streaming part of the JAX package's
 * spacedrive_tpu/native/blake3.c, written from the public BLAKE3
 * specification; ops/blake3_ref.py's StreamingBlake3 is its reference.
 * Memory stays bounded over unbounded input: the state holds one
 * pending chunk and a stack of at most 64 subtree chaining values.
 *
 * Plain C interface, loaded with ctypes (ops/blake3_host.py):
 *   b3_state_size, b3_init, b3_update, b3_finalize, b3_hash.
 */

#include <stdint.h>
#include <string.h>

#define CHUNK_LEN 1024u
#define BLOCK_LEN 64u

#define CHUNK_START (1u << 0)
#define CHUNK_END (1u << 1)
#define PARENT (1u << 2)
#define ROOT (1u << 3)

static const uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

static const uint8_t MSG_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};

static inline uint32_t rotr32(uint32_t x, int r) { return (x >> r) | (x << (32 - r)); }

static inline void g(uint32_t v[16], int a, int b, int c, int d, uint32_t mx, uint32_t my) {
  v[a] = v[a] + v[b] + mx;
  v[d] = rotr32(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr32(v[b] ^ v[c], 12);
  v[a] = v[a] + v[b] + my;
  v[d] = rotr32(v[d] ^ v[a], 8);
  v[c] = v[c] + v[d];
  v[b] = rotr32(v[b] ^ v[c], 7);
}

/* Full 16-word output (needed for root blocks). */
static void compress(const uint32_t h[8], const uint32_t m_in[16], uint64_t counter,
                     uint32_t block_len, uint32_t flags, uint32_t out[16]) {
  uint32_t v[16];
  uint32_t m[16], tmp[16];
  memcpy(m, m_in, sizeof(m));
  for (int i = 0; i < 8; i++) v[i] = h[i];
  for (int i = 0; i < 4; i++) v[8 + i] = IV[i];
  v[12] = (uint32_t)counter;
  v[13] = (uint32_t)(counter >> 32);
  v[14] = block_len;
  v[15] = flags;
  for (int r = 0; r < 7; r++) {
    g(v, 0, 4, 8, 12, m[0], m[1]);
    g(v, 1, 5, 9, 13, m[2], m[3]);
    g(v, 2, 6, 10, 14, m[4], m[5]);
    g(v, 3, 7, 11, 15, m[6], m[7]);
    g(v, 0, 5, 10, 15, m[8], m[9]);
    g(v, 1, 6, 11, 12, m[10], m[11]);
    g(v, 2, 7, 8, 13, m[12], m[13]);
    g(v, 3, 4, 9, 14, m[14], m[15]);
    if (r < 6) {
      for (int i = 0; i < 16; i++) tmp[i] = m[MSG_PERM[i]];
      memcpy(m, tmp, sizeof(m));
    }
  }
  for (int i = 0; i < 8; i++) {
    out[i] = v[i] ^ v[i + 8];
    out[i + 8] = v[i + 8] ^ h[i];
  }
}

static void words_of_block(const uint8_t *block, uint32_t len, uint32_t w[16]) {
  uint8_t buf[BLOCK_LEN];
  memset(buf, 0, sizeof(buf));
  memcpy(buf, block, len);
  for (int i = 0; i < 16; i++) {
    w[i] = (uint32_t)buf[4 * i] | ((uint32_t)buf[4 * i + 1] << 8) |
           ((uint32_t)buf[4 * i + 2] << 16) | ((uint32_t)buf[4 * i + 3] << 24);
  }
}

/* CV (or root words when is_root) of one <=1024-byte chunk. */
static void chunk_cv(const uint8_t *chunk, uint32_t len, uint64_t counter, int is_root,
                     uint32_t out16[16]) {
  uint32_t h[8];
  memcpy(h, IV, sizeof(h));
  uint32_t n_blocks = len == 0 ? 1 : (len + BLOCK_LEN - 1) / BLOCK_LEN;
  for (uint32_t b = 0; b < n_blocks; b++) {
    uint32_t off = b * BLOCK_LEN;
    uint32_t blen = len - off > BLOCK_LEN ? BLOCK_LEN : len - off;
    uint32_t flags = 0;
    if (b == 0) flags |= CHUNK_START;
    if (b == n_blocks - 1) {
      flags |= CHUNK_END;
      if (is_root) flags |= ROOT;
    }
    uint32_t w[16];
    words_of_block(chunk + off, blen, w);
    compress(h, w, counter, blen, flags, out16);
    if (b < n_blocks - 1) memcpy(h, out16, 8 * sizeof(uint32_t));
  }
}

static void parent_cv(const uint32_t left[8], const uint32_t right[8], int is_root,
                      uint32_t out16[16]) {
  uint32_t m[16];
  memcpy(m, left, 8 * sizeof(uint32_t));
  memcpy(m + 8, right, 8 * sizeof(uint32_t));
  compress(IV, m, 0, BLOCK_LEN, PARENT | (is_root ? ROOT : 0), out16);
}

/* ---- streaming state (bounded memory over unbounded input) ---- */

typedef struct {
  uint32_t stack[64][8];
  uint64_t stack_bits; /* bit d set => stack[d] holds a 2^d-chunk subtree CV */
  uint64_t count;      /* chunks fully absorbed */
  uint8_t pending[CHUNK_LEN];
  uint32_t pending_len;
} b3_state;

void b3_init(b3_state *s) {
  s->stack_bits = 0;
  s->count = 0;
  s->pending_len = 0;
}

static void push_chunk_cv(b3_state *s, const uint32_t cv_in[8]) {
  uint32_t cv[8], out16[16];
  memcpy(cv, cv_in, sizeof(cv));
  s->count++;
  uint64_t count = s->count;
  int d = 0;
  while ((count & 1) == 0) {
    parent_cv(s->stack[d], cv, 0, out16);
    memcpy(cv, out16, sizeof(cv));
    s->stack_bits &= ~(1ull << d);
    count >>= 1;
    d++;
  }
  memcpy(s->stack[d], cv, sizeof(cv));
  s->stack_bits |= 1ull << d;
}

void b3_update(b3_state *s, const uint8_t *data, uint64_t len) {
  uint64_t off = 0;
  /* Hold the final chunk out: only absorb a chunk once at least one
   * byte beyond its boundary has been seen. */
  while (s->pending_len + (len - off) > CHUNK_LEN) {
    uint32_t take = CHUNK_LEN - s->pending_len;
    if (take > len - off) take = (uint32_t)(len - off);
    memcpy(s->pending + s->pending_len, data + off, take);
    s->pending_len += take;
    off += take;
    if (s->pending_len == CHUNK_LEN && off < len) {
      uint32_t out16[16];
      chunk_cv(s->pending, CHUNK_LEN, s->count, 0, out16);
      push_chunk_cv(s, out16);
      s->pending_len = 0;
    }
  }
  uint64_t rest = len - off;
  memcpy(s->pending + s->pending_len, data + off, rest);
  s->pending_len += (uint32_t)rest;
}

void b3_finalize(const b3_state *s, uint8_t *out, uint32_t out_len) {
  uint32_t out16[16];
  if (s->count == 0) {
    chunk_cv(s->pending, s->pending_len, 0, 1, out16);
  } else {
    uint32_t cv[8];
    chunk_cv(s->pending, s->pending_len, s->count, 0, out16);
    memcpy(cv, out16, sizeof(cv));
    int highest = 63;
    while (highest > 0 && !((s->count >> highest) & 1)) highest--;
    for (int d = 0; d < 64; d++) {
      if ((s->count >> d) & 1) {
        parent_cv(s->stack[d], cv, d == highest, out16);
        memcpy(cv, out16, sizeof(cv));
      }
    }
  }
  uint8_t bytes[64];
  for (int i = 0; i < 16; i++) {
    bytes[4 * i] = (uint8_t)out16[i];
    bytes[4 * i + 1] = (uint8_t)(out16[i] >> 8);
    bytes[4 * i + 2] = (uint8_t)(out16[i] >> 16);
    bytes[4 * i + 3] = (uint8_t)(out16[i] >> 24);
  }
  memcpy(out, bytes, out_len > 64 ? 64 : out_len);
}

uint32_t b3_state_size(void) { return (uint32_t)sizeof(b3_state); }

void b3_hash(const uint8_t *data, uint64_t len, uint8_t *out, uint32_t out_len) {
  b3_state s;
  b3_init(&s);
  b3_update(&s, data, len);
  b3_finalize(&s, out, out_len);
}
