// Vorbis residue + codebook hot loop (native host helper).
//
// The per-symbol Huffman/VQ walk (spec §8.6 residue formats 0/1/2 over
// §3 canonical codebooks) is bit-serial and branchy — the one part of
// Vorbis decode that can't be batched onto the device.  The reference
// runs it in C (Tremor res012.c / codebook.c); this is the equivalent
// helper for this framework, behind a pure-Python fallback
// (codecs/vorbis/residue.py) that stays bit-for-bit identical — the
// Python LUT decode and this one make the same EOP/invalid-codeword
// decisions on the same bit positions.
//
// Contract with native/__init__.py:
//  * packet buffer must be padded with >= 8 trailing zero bytes so the
//    bit peek can do one unaligned 64-bit load;
//  * out is nvec rows of n float64, pre-zeroed by the caller;
//  * return 0 = decoded (end-of-packet mid-residue included: partial
//    vectors stand, spec §1.3.2), 2 = invalid codeword, 3 = scalar
//    book used for VQ (both map to VorbisError in Python).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kLutBits = 11;  // matches codebook.Codebook.LUT_BITS

struct Book {
  int32_t dims = 0;
  int32_t entries = 0;
  int32_t single_entry = -1;  // >=0: single-used-entry book
  int32_t single_len = 0;
  int32_t max_len = 1;
  std::vector<int32_t> lut_entry;           // 1<<kLutBits, -1 = miss
  std::vector<uint8_t> lut_len;
  std::unordered_map<uint64_t, int32_t> long_codes;  // rev | len<<40
  std::vector<double> vec;                  // entries*dims, empty = scalar
  bool valid = false;
};

struct Ctx {
  std::vector<Book> books;
};

uint32_t reverse_bits(uint32_t x, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) {
    r = (r << 1) | (x & 1);
    x >>= 1;
  }
  return r;
}

// Canonical Vorbis codeword assignment (spec §3.2.1), identical to
// codecs/vorbis/codebook.assign_codewords.  Returns false when the
// codebook is over-specified.
bool assign_codewords(const uint8_t* lengths, int entries,
                      std::vector<uint32_t>& codes,
                      std::vector<int32_t>& which) {
  uint64_t available[33] = {0};
  bool first = true;
  for (int i = 0; i < entries; ++i) {
    int l = lengths[i];
    if (l <= 0) continue;
    if (first) {
      codes.push_back(0);
      which.push_back(i);
      for (int j = 1; j <= l; ++j) available[j] = 1ull << (32 - j);
      first = false;
      continue;
    }
    int j = l;
    while (j > 0 && available[j] == 0) --j;
    if (j == 0) return false;
    uint64_t c = available[j];
    available[j] = 0;
    for (int k = j + 1; k <= l; ++k) available[k] = c + (1ull << (32 - k));
    codes.push_back(static_cast<uint32_t>(c >> (32 - l)));
    which.push_back(i);
  }
  return true;
}

bool build_book(Book& bk, const uint8_t* lengths) {
  int used = 0, last_used = -1;
  for (int i = 0; i < bk.entries; ++i)
    if (lengths[i] > 0) {
      ++used;
      last_used = i;
      if (lengths[i] > bk.max_len) bk.max_len = lengths[i];
    }
  if (used == 1) {
    bk.single_entry = last_used;
    bk.single_len = lengths[last_used];
    bk.valid = true;
    return true;
  }
  std::vector<uint32_t> codes;
  std::vector<int32_t> which;
  if (used > 0 && !assign_codewords(lengths, bk.entries, codes, which))
    return false;
  bk.lut_entry.assign(1u << kLutBits, -1);
  bk.lut_len.assign(1u << kLutBits, 0);
  for (size_t t = 0; t < codes.size(); ++t) {
    int entry = which[t];
    int l = lengths[entry];
    uint32_t rev = reverse_bits(codes[t], l);
    if (l <= kLutBits) {
      uint32_t step = 1u << l;
      for (uint32_t base = rev; base < (1u << kLutBits); base += step) {
        bk.lut_entry[base] = entry;
        bk.lut_len[base] = static_cast<uint8_t>(l);
      }
    } else {
      bk.long_codes.emplace(static_cast<uint64_t>(rev) |
                                (static_cast<uint64_t>(l) << 40),
                            entry);
    }
  }
  bk.valid = true;
  return true;
}

struct Br {
  const uint8_t* data;  // padded with >= 8 zero bytes past nbits
  int64_t nbits;
  int64_t pos;

  // Up to 57 valid bits from pos, zero-padded past the packet end
  // (LSB-first arrival, same as bitreader.LsbBitReader.peek).
  inline uint64_t peek() const {
    uint64_t w;
    std::memcpy(&w, data + (pos >> 3), 8);  // little-endian host
    return w >> (pos & 7);
  }
  inline int64_t bits_left() const { return nbits - pos; }
};

// status: 0 ok, 1 EOP (pos unchanged), 2 invalid codeword.
inline int32_t book_decode(const Book& bk, Br& br, int& status) {
  if (bk.single_entry >= 0) {
    if (br.bits_left() < bk.single_len) {
      status = 1;
      return -1;
    }
    br.pos += bk.single_len;
    return bk.single_entry;
  }
  uint64_t w = br.peek();
  if (bk.max_len < 64) w &= (1ull << bk.max_len) - 1;
  uint32_t idx = static_cast<uint32_t>(w) & ((1u << kLutBits) - 1);
  int32_t e = bk.lut_entry[idx];
  if (e >= 0) {
    int need = bk.lut_len[idx];
    if (br.bits_left() < need) {
      status = 1;
      return -1;
    }
    br.pos += need;
    return e;
  }
  for (int l = kLutBits + 1; l <= bk.max_len; ++l) {
    auto it = bk.long_codes.find((w & ((1ull << l) - 1)) |
                                 (static_cast<uint64_t>(l) << 40));
    if (it != bk.long_codes.end()) {
      if (br.bits_left() < l) {
        status = 1;
        return -1;
      }
      br.pos += l;
      return it->second;
    }
  }
  status = 2;
  return -1;
}

// status: 0 ok, 1 EOP, 2 invalid codeword, 3 scalar book used for VQ.
inline void decode_partition(const Book& bk, Br& br, int kind, double* v,
                             int64_t offset, int64_t psize, int64_t n,
                             int& status) {
  if (bk.vec.empty()) {
    status = 3;
    return;
  }
  const int64_t dims = bk.dims;
  if (kind == 0) {
    int64_t step = psize / dims;
    for (int64_t i = 0; i < step; ++i) {
      int32_t entry = book_decode(bk, br, status);
      if (status) return;
      const double* e = &bk.vec[static_cast<int64_t>(entry) * dims];
      for (int64_t d = 0; d < dims; ++d) {
        int64_t at = offset + i + d * step;
        if (at < n) v[at] += e[d];
      }
    }
  } else {  // formats 1 and 2
    for (int64_t i = 0; i < psize; i += dims) {
      int32_t entry = book_decode(bk, br, status);
      if (status) return;
      const double* e = &bk.vec[static_cast<int64_t>(entry) * dims];
      int64_t lim = dims;
      if (offset + i + lim > n) lim = n - (offset + i);
      for (int64_t d = 0; d < lim; ++d) v[offset + i + d] += e[d];
    }
  }
}

}  // namespace

extern "C" {

void* vorbis_ctx_create(int32_t n_books, const int32_t* dims,
                        const int32_t* entries,
                        const uint8_t* lengths_concat,
                        const uint8_t* has_vec,
                        const double* vectors_concat) {
  Ctx* ctx = new Ctx();
  ctx->books.resize(n_books);
  const uint8_t* lp = lengths_concat;
  const double* vp = vectors_concat;
  for (int b = 0; b < n_books; ++b) {
    Book& bk = ctx->books[b];
    bk.dims = dims[b];
    bk.entries = entries[b];
    if (!build_book(bk, lp)) {
      delete ctx;
      return nullptr;
    }
    lp += bk.entries;
    if (has_vec[b]) {
      bk.vec.assign(vp, vp + static_cast<int64_t>(bk.entries) * bk.dims);
      vp += static_cast<int64_t>(bk.entries) * bk.dims;
    }
  }
  return ctx;
}

void vorbis_ctx_destroy(void* ctx) { delete static_cast<Ctx*>(ctx); }

// Mirrors residue._decode_vectors: 8 passes, classword decode on pass 0,
// partition decode per (pass, partition, vector).  EOP terminates the
// residue normally (partial vectors stand).
int32_t vorbis_residue_decode(void* vctx, const uint8_t* data, int64_t nbits,
                              int64_t* bitpos, int32_t kind, int64_t begin,
                              int64_t end, int64_t psize,
                              int32_t classifications, int32_t classbook,
                              const int32_t* res_books, int32_t nvec,
                              const uint8_t* dnd, double* out, int64_t n) {
  Ctx* ctx = static_cast<Ctx*>(vctx);
  if (begin > n) begin = n;
  if (end > n) end = n;
  if (end <= begin) return 0;
  int64_t to_read = (end - begin) / psize;
  if (to_read == 0) return 0;
  const Book& cbook = ctx->books[classbook];
  const int64_t cw = cbook.dims;
  std::vector<int32_t> classif(
      static_cast<size_t>(nvec) * (to_read + cw), 0);
  Br br{data, nbits, *bitpos};
  int status = 0;
  for (int p = 0; p < 8; ++p) {
    int64_t pc = 0;
    while (pc < to_read) {
      if (p == 0) {
        for (int j = 0; j < nvec; ++j) {
          if (dnd[j]) continue;
          int64_t temp = book_decode(cbook, br, status);
          if (status) goto done;
          for (int64_t i = cw - 1; i >= 0; --i) {
            classif[j * (to_read + cw) + pc + i] =
                static_cast<int32_t>(temp % classifications);
            temp /= classifications;
          }
        }
      }
      for (int64_t k = 0; k < cw; ++k) {
        if (pc >= to_read) break;
        for (int j = 0; j < nvec; ++j) {
          if (dnd[j]) continue;
          int32_t cls = classif[j * (to_read + cw) + pc];
          int32_t book_i = res_books[cls * 8 + p];
          if (book_i >= 0) {
            decode_partition(ctx->books[book_i], br, kind, out + j * n,
                             begin + pc * psize, psize, n, status);
            if (status) goto done;
          }
        }
        ++pc;
      }
    }
  }
done:
  *bitpos = br.pos;
  if (status == 1) status = 0;  // EOP = normal termination
  return status;
}

}  // extern "C"
