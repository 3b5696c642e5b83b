// Native LMDB (mdb v1) read-only B+tree lookup over a memory-mapped file.
//
// From-scratch implementation of the on-disk format (see the layout notes in
// ../lmdb_format.py — the pure-Python twin used for cross-validation). This
// is the hot-path backend for the region-feature reader: a get() is a
// handful of page-header reads plus binary searches over mmapped memory with
// zero copies until the caller asks for the value bytes.
//
// C ABI (ctypes):
//   void*   mdbr_open(const char* path);            // NULL on failure
//   int64_t mdbr_entries(void* h);
//   int     mdbr_get(void* h, const uint8_t* key, uint32_t klen,
//                    const uint8_t** out, uint64_t* out_len);  // 1=found
//   int     mdbr_iter_begin(void* h);
//   int     mdbr_iter_next(void* h, const uint8_t** k, uint64_t* klen,
//                          const uint8_t** v, uint64_t* vlen);  // 1=ok 0=end
//   void    mdbr_close(void* h);

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint32_t kVersion = 1;
constexpr size_t kPageHdr = 16;
constexpr uint16_t kBranch = 0x01;
constexpr uint16_t kLeaf = 0x02;
constexpr uint16_t kBigData = 0x01;
constexpr uint64_t kInvalid = ~0ULL;

template <typename T>
T rd(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

struct Handle {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t size = 0;
  uint64_t psize = 0, root = 0, entries = 0;
  // iterator state: stack of (pgno, index)
  std::vector<std::pair<uint64_t, uint32_t>> stack;

  const uint8_t* page(uint64_t pgno) const { return map + pgno * psize; }
  uint16_t flags(const uint8_t* pg) const { return rd<uint16_t>(pg + 10); }
  uint32_t numkeys(const uint8_t* pg) const {
    return (rd<uint16_t>(pg + 12) - kPageHdr) / 2;
  }
  const uint8_t* node(const uint8_t* pg, uint32_t i) const {
    return pg + rd<uint16_t>(pg + kPageHdr + 2 * i);
  }
  static uint16_t ksize(const uint8_t* nd) { return rd<uint16_t>(nd + 6); }
  static const uint8_t* keyp(const uint8_t* nd) { return nd + 8; }
  static uint64_t child_pgno(const uint8_t* nd) {
    return (uint64_t)rd<uint16_t>(nd) | ((uint64_t)rd<uint16_t>(nd + 2) << 16) |
           ((uint64_t)rd<uint16_t>(nd + 4) << 32);
  }
  bool leaf_value(const uint8_t* nd, const uint8_t** out,
                  uint64_t* out_len) const {
    uint64_t dsize =
        (uint64_t)rd<uint16_t>(nd) | ((uint64_t)rd<uint16_t>(nd + 2) << 16);
    uint16_t nflags = rd<uint16_t>(nd + 4);
    uint16_t ks = ksize(nd);
    if (nflags & kBigData) {
      uint64_t ovf = rd<uint64_t>(nd + 8 + ks);
      *out = page(ovf) + kPageHdr;
    } else {
      *out = nd + 8 + ks;
    }
    *out_len = dsize;
    return true;
  }
};

int key_cmp(const uint8_t* a, size_t alen, const uint8_t* b, size_t blen) {
  size_t n = alen < blen ? alen : blen;
  int c = std::memcmp(a, b, n);
  if (c) return c;
  return alen < blen ? -1 : (alen > blen ? 1 : 0);
}

}  // namespace

extern "C" {

void* mdbr_open(const char* path) {
  std::string p(path);
  struct stat st;
  if (stat(p.c_str(), &st) == 0 && S_ISDIR(st.st_mode)) p += "/data.mdb";
  int fd = ::open(p.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  if (fstat(fd, &st) != 0 || st.st_size < 8192) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* h = new Handle;
  h->fd = fd;
  h->map = static_cast<const uint8_t*>(map);
  h->size = st.st_size;

  // meta 0 at offset 0 carries the true page size; meta 1 lives one page
  // later AT THAT PSIZE (liblmdb uses the OS page size — not always 4096)
  uint64_t best_txn = 0;
  bool found = false;
  uint64_t psize0 = 4096;
  for (int pg = 0; pg < 2; ++pg) {
    size_t off = (pg == 0 ? 0 : psize0) + kPageHdr;
    // the meta struct spans 136 bytes from `off` (txnid ends at off+136)
    if (off + 136 > h->size) continue;
    const uint8_t* m = h->map + off;
    if (rd<uint32_t>(m) != kMagic || rd<uint32_t>(m + 4) != kVersion) continue;
    const uint8_t* db0 = m + 8 + 16;
    uint64_t psize = rd<uint32_t>(db0);
    // sanity-check the file-provided page size before using it as an offset
    if (psize < 512 || psize > (1u << 20) || (psize & (psize - 1)) != 0)
      continue;
    if (pg == 0) psize0 = psize;
    const uint8_t* db1 = db0 + 48;
    uint64_t entries = rd<uint64_t>(db1 + 32);
    uint64_t root = rd<uint64_t>(db1 + 40);
    uint64_t txnid = rd<uint64_t>(db1 + 48 + 8);
    if (!found || txnid > best_txn) {
      best_txn = txnid;
      h->psize = psize;
      h->entries = entries;
      h->root = root;
      found = true;
    }
  }
  if (!found || h->psize == 0) {
    mdbr_close_impl:
    munmap(const_cast<uint8_t*>(h->map), h->size);
    ::close(h->fd);
    delete h;
    return nullptr;
  }
  return h;
}

int64_t mdbr_entries(void* hv) {
  return static_cast<Handle*>(hv)->entries;
}

int mdbr_get(void* hv, const uint8_t* key, uint32_t klen, const uint8_t** out,
             uint64_t* out_len) {
  auto* h = static_cast<Handle*>(hv);
  if (h->root == kInvalid) return 0;
  const uint8_t* pg = h->page(h->root);
  while (true) {
    uint16_t fl = h->flags(pg);
    uint32_t n = h->numkeys(pg);
    if (fl & kBranch) {
      uint32_t lo = 1, hi = n;
      while (lo < hi) {
        uint32_t mid = (lo + hi) / 2;
        const uint8_t* nd = h->node(pg, mid);
        if (key_cmp(Handle::keyp(nd), Handle::ksize(nd), key, klen) <= 0)
          lo = mid + 1;
        else
          hi = mid;
      }
      pg = h->page(Handle::child_pgno(h->node(pg, lo - 1)));
    } else if (fl & kLeaf) {
      int64_t lo = 0, hi = (int64_t)n - 1;
      while (lo <= hi) {
        int64_t mid = (lo + hi) / 2;
        const uint8_t* nd = h->node(pg, (uint32_t)mid);
        int c = key_cmp(Handle::keyp(nd), Handle::ksize(nd), key, klen);
        if (c == 0) return h->leaf_value(nd, out, out_len) ? 1 : 0;
        if (c < 0)
          lo = mid + 1;
        else
          hi = mid - 1;
      }
      return 0;
    } else {
      return 0;
    }
  }
}

int mdbr_iter_begin(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  h->stack.clear();
  if (h->root == kInvalid) return 0;
  uint64_t pgno = h->root;
  while (true) {
    const uint8_t* pg = h->page(pgno);
    h->stack.emplace_back(pgno, 0);
    if (h->flags(pg) & kLeaf) break;
    pgno = Handle::child_pgno(h->node(pg, 0));
  }
  return 1;
}

int mdbr_iter_next(void* hv, const uint8_t** k, uint64_t* klen,
                   const uint8_t** v, uint64_t* vlen) {
  auto* h = static_cast<Handle*>(hv);
  while (!h->stack.empty()) {
    auto& [pgno, idx] = h->stack.back();
    const uint8_t* pg = h->page(pgno);
    uint32_t n = h->numkeys(pg);
    if (idx >= n) {
      h->stack.pop_back();
      if (!h->stack.empty()) h->stack.back().second++;
      continue;
    }
    if (h->flags(pg) & kBranch) {
      uint64_t child = Handle::child_pgno(h->node(pg, idx));
      // descend to leftmost leaf of this child
      uint64_t c = child;
      while (true) {
        const uint8_t* cpg = h->page(c);
        h->stack.emplace_back(c, 0);
        if (h->flags(cpg) & kLeaf) break;
        c = Handle::child_pgno(h->node(cpg, 0));
      }
      continue;
    }
    const uint8_t* nd = h->node(pg, idx);
    *k = Handle::keyp(nd);
    *klen = Handle::ksize(nd);
    h->leaf_value(nd, v, vlen);
    idx++;  // advance within leaf
    return 1;
  }
  return 0;
}

void mdbr_close(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  munmap(const_cast<uint8_t*>(h->map), h->size);
  ::close(h->fd);
  delete h;
}

}  // extern "C"
