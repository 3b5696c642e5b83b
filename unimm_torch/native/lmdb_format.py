"""From-scratch LMDB (mdb v1) file-format reader/writer in pure Python.

The port's copy of the JAX package's ``native/lmdb_format.py``.

The reference stores region features in an LMDB environment
(the reference's utils/image_features_reader.py:40-44) read via the ``lmdb``
package (liblmdb). The framework needs neither the package nor the shared
library: it implements the on-disk format directly:

* read-only B+tree lookup over a memory-mapped ``data.mdb`` (this module and
  the C++ twin in native/src/lmdb_reader.cc);
* a minimal writer producing format-valid single-tree environments, used for
  test fixtures and as an export target.

Format summary (liblmdb 0.9.x, little-endian, 64-bit sizes):

  page header (16B): u64 pgno | u16 pad | u16 flags | u16 lower | u16 upper
                     (overflow pages: u32 n_pages overlays lower/upper)
  meta page (pages 0 and 1): header + MDB_meta
      u32 magic=0xBEEFC0DE | u32 version=1 | u64 address | u64 mapsize |
      MDB_db dbs[2] | u64 last_pg | u64 txnid
      MDB_db (48B): u32 pad | u16 flags | u16 depth | u64 branch_pages |
                    u64 leaf_pages | u64 overflow_pages | u64 entries |
                    u64 root          -- dbs[0].pad holds the page size
  branch/leaf page: header + u16 ptrs[numkeys] (offsets from page start),
      numkeys = (lower - 16) / 2
  node (8B header): u16 lo | u16 hi | u16 flags | u16 ksize | key | data
      branch: child pgno = lo | hi<<16 | flags<<32; data none
      leaf:   datasize = lo | hi<<16; flags&1 (BIGDATA) -> data is u64
              overflow pgno; overflow data starts at that page + 16
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

MAGIC = 0xBEEFC0DE
VERSION = 1
PAGEHDRSZ = 16

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

INVALID_PGNO = 0xFFFFFFFFFFFFFFFF


def _data_path(path: str) -> str:
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


class Reader:
    """Read-only single-tree (MAIN_DBI) lookup."""

    def __init__(self, path: str):
        self.path = _data_path(path)
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = self._pick_meta()
        (self.psize, self.depth, self.entries, self.root) = meta

    # -- meta ---------------------------------------------------------------
    def _read_meta(self, off: int):
        mm = self._mm
        if off + 136 > len(mm):   # meta struct spans 136 bytes from off
            return None
        magic, version = struct.unpack_from("<II", mm, off)
        if magic != MAGIC or version != VERSION:
            return None
        # address(8) mapsize(8) then dbs[2]
        db0 = off + 8 + 16
        psize = struct.unpack_from("<I", mm, db0)[0]
        db1 = db0 + 48
        (pad, flags, depth, branch, leaf, ovf, entries, root) = \
            struct.unpack_from("<IHHQQQQQ", mm, db1)
        txnid = struct.unpack_from("<Q", mm, db1 + 48 + 8)[0]
        return txnid, (psize, depth, entries, root)

    def _pick_meta(self):
        # meta 0 is always at offset 0; read the true page size from it, then
        # locate meta 1 at that psize (liblmdb uses the OS page size, which
        # is 16K on some hosts — a fixed 4096 probe would silently serve the
        # stale meta 0 snapshot)
        meta0 = self._read_meta(PAGEHDRSZ)
        best = meta0
        psize = meta0[1][0] if meta0 else 4096
        if not (512 <= psize <= 1 << 20) or psize & (psize - 1):
            psize = 4096   # implausible psize field: don't trust the offset
        meta1 = self._read_meta(psize + PAGEHDRSZ)
        if meta1 and (best is None or meta1[0] > best[0]):
            best = meta1
        if best is None:
            raise ValueError(f"not an LMDB data file: {self.path}")
        return best[1]

    # -- pages --------------------------------------------------------------
    def _page(self, pgno: int) -> int:
        return pgno * self.psize

    def _page_flags(self, off: int) -> int:
        return struct.unpack_from("<H", self._mm, off + 10)[0]

    def _numkeys(self, off: int) -> int:
        lower = struct.unpack_from("<H", self._mm, off + 12)[0]
        return (lower - PAGEHDRSZ) // 2

    def _node(self, page_off: int, i: int) -> int:
        ptr = struct.unpack_from("<H", self._mm, page_off + PAGEHDRSZ + 2 * i)[0]
        return page_off + ptr

    def _node_key(self, node_off: int) -> bytes:
        ksize = struct.unpack_from("<H", self._mm, node_off + 6)[0]
        return bytes(self._mm[node_off + 8: node_off + 8 + ksize])

    def _branch_child(self, node_off: int) -> int:
        lo, hi, flags = struct.unpack_from("<HHH", self._mm, node_off)
        return lo | (hi << 16) | (flags << 32)

    def _leaf_value(self, node_off: int) -> bytes:
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._mm, node_off)
        dsize = lo | (hi << 16)
        if flags & F_BIGDATA:
            ovf_pgno = struct.unpack_from("<Q", self._mm,
                                          node_off + 8 + ksize)[0]
            start = self._page(ovf_pgno) + PAGEHDRSZ
            return bytes(self._mm[start: start + dsize])
        start = node_off + 8 + ksize
        return bytes(self._mm[start: start + dsize])

    # -- lookup -------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        if self.root == INVALID_PGNO:
            return None
        off = self._page(self.root)
        while True:
            flags = self._page_flags(off)
            n = self._numkeys(off)
            if flags & P_BRANCH:
                lo_i, hi_i = 1, n           # node 0 key is implicit -inf
                while lo_i < hi_i:          # first node with key > target
                    mid = (lo_i + hi_i) // 2
                    if self._node_key(self._node(off, mid)) <= key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid
                child = self._branch_child(self._node(off, lo_i - 1))
                off = self._page(child)
            elif flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    node = self._node(off, mid)
                    k = self._node_key(node)
                    if k == key:
                        return self._leaf_value(node)
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:
                raise ValueError(f"unexpected page flags {flags:#x}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order iteration over all (key, value) pairs."""
        if self.root == INVALID_PGNO:
            return

        def walk(pgno):
            off = self._page(pgno)
            flags = self._page_flags(off)
            n = self._numkeys(off)
            if flags & P_BRANCH:
                for i in range(n):
                    yield from walk(self._branch_child(self._node(off, i)))
            else:
                for i in range(n):
                    node = self._node(off, i)
                    yield self._node_key(node), self._leaf_value(node)

        yield from walk(self.root)

    def close(self):
        self._mm.close()
        self._f.close()


# ---------------------------------------------------------------------------
# writer (fixtures + export)
# ---------------------------------------------------------------------------

class Writer:
    """Builds a format-valid single-tree environment in one shot."""

    def __init__(self, psize: int = 4096):
        self.psize = psize

    def write(self, path: str, items: List[Tuple[bytes, bytes]]):
        psize = self.psize
        items = sorted(items)
        pages: List[bytes] = [b"", b""]       # meta placeholders
        counts = {"branch": 0, "leaf": 0, "ovf": 0}

        def new_page() -> int:
            pages.append(b"")
            return len(pages) - 1

        def page_bytes(pgno, flags, nodes: List[bytes], n_pages=1) -> bytes:
            """nodes laid out after the ptr array."""
            ptrs = []
            off = PAGEHDRSZ + 2 * len(nodes)
            blob = b""
            for nd in nodes:
                ptrs.append(off)
                blob += nd
                off += len(nd)
            lower = PAGEHDRSZ + 2 * len(nodes)
            upper = psize  # not used by readers; keep spec-plausible
            hdr = struct.pack("<QHHHH", pgno, 0, flags, lower, upper)
            body = hdr + b"".join(struct.pack("<H", p) for p in ptrs) + blob
            assert len(body) <= psize * n_pages, "page overflow"
            return body.ljust(psize * n_pages, b"\0")

        def leaf_node(key: bytes, value: bytes, big_pgno=None) -> bytes:
            dsize = len(value)
            lo, hi = dsize & 0xFFFF, (dsize >> 16) & 0xFFFF
            flags = F_BIGDATA if big_pgno is not None else 0
            nd = struct.pack("<HHHH", lo, hi, flags, len(key)) + key
            if big_pgno is not None:
                nd += struct.pack("<Q", big_pgno)
            else:
                nd += value
            if len(nd) % 2:
                nd += b"\0"
            return nd

        def branch_node(key: bytes, child_pgno: int) -> bytes:
            lo = child_pgno & 0xFFFF
            hi = (child_pgno >> 16) & 0xFFFF
            fl = (child_pgno >> 32) & 0xFFFF
            nd = struct.pack("<HHHH", lo, hi, fl, len(key)) + key
            if len(nd) % 2:
                nd += b"\0"
            return nd

        # ---- build leaves ----
        max_inline = (psize - PAGEHDRSZ) // 2 - 16
        leaf_entries: List[Tuple[bytes, bytes]] = []   # (first_key, pgno)
        leaves: List[Tuple[int, List[bytes]]] = []
        cur_nodes: List[bytes] = []
        cur_first: Optional[bytes] = None
        cur_size = PAGEHDRSZ

        def flush_leaf():
            nonlocal cur_nodes, cur_first, cur_size
            if not cur_nodes:
                return
            pgno = new_page()
            leaves.append((pgno, list(cur_nodes)))
            leaf_entries.append((cur_first, pgno))
            counts["leaf"] += 1
            cur_nodes, cur_first, cur_size = [], None, PAGEHDRSZ

        ovf_blobs: List[Tuple[int, bytes, int]] = []
        for key, value in items:
            if len(key) + len(value) + 8 > max_inline:
                n_pages = -(-(len(value) + PAGEHDRSZ) // psize)
                ovf_pgno = None  # assigned after leaves/branches? must be now
                ovf_pgno = new_page()
                for _ in range(n_pages - 1):
                    new_page()
                counts["ovf"] += n_pages
                ovf_blobs.append((ovf_pgno, value, n_pages))
                nd = leaf_node(key, value, big_pgno=ovf_pgno)
            else:
                nd = leaf_node(key, value)
            if cur_size + len(nd) + 2 > psize - 16:
                flush_leaf()
            if cur_first is None:
                cur_first = key
            cur_nodes.append(nd)
            cur_size += len(nd) + 2
        flush_leaf()

        # ---- build branches bottom-up ----
        level = leaf_entries
        depth = 1
        while len(level) > 1:
            next_level = []
            group: List[Tuple[bytes, int]] = []
            size = PAGEHDRSZ

            def flush_branch():
                nonlocal group, size
                if not group:
                    return
                pgno = new_page()
                nodes = []
                for idx, (k, child) in enumerate(group):
                    nodes.append(branch_node(b"" if idx == 0 else k, child))
                pages[pgno] = page_bytes(pgno, P_BRANCH, nodes)
                next_level.append((group[0][0], pgno))
                counts["branch"] += 1
                group, size = [], PAGEHDRSZ

            for k, child in level:
                nd_len = 8 + len(k) + 2
                if size + nd_len > psize - 16:
                    flush_branch()
                group.append((k, child))
                size += nd_len
            flush_branch()
            level = next_level
            depth += 1

        root = level[0][1] if level else INVALID_PGNO

        # ---- materialise leaf + overflow pages ----
        for pgno, nodes in leaves:
            pages[pgno] = page_bytes(pgno, P_LEAF, nodes)
        for pgno, value, n_pages in ovf_blobs:
            hdr = struct.pack("<QHHI", pgno, 0, P_OVERFLOW, n_pages)
            body = (hdr + value).ljust(psize * n_pages, b"\0")
            pages[pgno] = body

        # ---- meta pages ----
        def meta_page(pgno, txnid):
            hdr = struct.pack("<QHHHH", pgno, 0, P_META, PAGEHDRSZ, psize)
            db0 = struct.pack("<IHHQQQQQ", psize, 0, 0, 0, 0, 0, 0,
                              INVALID_PGNO)
            db1 = struct.pack("<IHHQQQQQ", 0, 0, depth,
                              counts["branch"], counts["leaf"], counts["ovf"],
                              len(items), root)
            meta = struct.pack("<IIQQ", MAGIC, VERSION, 0,
                               psize * len(pages)) + db0 + db1 + \
                struct.pack("<QQ", len(pages) - 1, txnid)
            return (hdr + meta).ljust(psize, b"\0")

        pages[0] = meta_page(0, 1)
        pages[1] = meta_page(1, 2)

        out = _data_path(path)
        if path.endswith(".lmdb") and not os.path.exists(path):
            os.makedirs(path, exist_ok=True)
            out = os.path.join(path, "data.mdb")
        with open(out, "wb") as f:
            for body in pages:
                f.write(body)
