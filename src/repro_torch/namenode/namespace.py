"""The NameNode's in-memory namespace: directory tree + extent maps.

HDFS-style split: the *namespace* maps paths to inodes and files to
ordered lists of :class:`Block`; where a block's bytes physically live
is the ``placements`` list (datanode ids), stamped with a monotonically
increasing *generation stamp*.  The stamp bumps every time a block's
placement set changes (initial allocation, re-replication after a
detected failure), which is what lets datanodes and clients fence stale
replicas: a replica carrying an old stamp is garbage, not data.

This module is pure bookkeeping — no bytes, no IO, no liveness.  The
:class:`~repro_torch.namenode.NameNode` facade wires it to `StorageCluster`
(bytes) and `repro_torch.membership` (liveness).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator

__all__ = ["Block", "FileNode", "DirNode", "Namespace"]


@dataclasses.dataclass
class Block:
    """One fixed-position chunk of a file and where its replicas live."""

    block_id: int
    size: int
    gen_stamp: int
    placements: list[int]               # datanode ids holding a replica
    object_id: int | None = None        # backing StorageCluster object

    def replicas_on(self, nodes) -> int:
        return sum(1 for v in self.placements if v in nodes)


@dataclasses.dataclass
class FileNode:
    name: str
    replication: int
    blocks: list[Block] = dataclasses.field(default_factory=list)

    @property
    def size(self) -> int:
        return sum(b.size for b in self.blocks)


@dataclasses.dataclass
class DirNode:
    name: str
    children: dict = dataclasses.field(default_factory=dict)


class Namespace:
    """Slash-separated directory tree with per-file block lists.

    Mutations are O(path depth); lookups return the inode itself (the
    NameNode's RPC layer decides what subset to serialize).  Paths are
    absolute (``/a/b/c``); the root directory always exists."""

    def __init__(self):
        self.root = DirNode("/")
        self._next_block_id = 0
        self._gen_stamp = 0
        self.num_files = 0
        self.num_dirs = 1

    # -- path plumbing -------------------------------------------------------

    @staticmethod
    def _parts(path: str) -> list[str]:
        if not path.startswith("/"):
            raise ValueError(f"paths are absolute, got {path!r}")
        return [p for p in path.split("/") if p]

    def _walk(self, parts: list[str]) -> DirNode:
        node = self.root
        for p in parts:
            child = node.children.get(p)
            if not isinstance(child, DirNode):
                raise FileNotFoundError(f"no such directory: {p!r}")
            node = child
        return node

    # -- namespace ops (the lookup/open/commit RPC bodies) -------------------

    def mkdir(self, path: str) -> DirNode:
        """Create directories along ``path`` (mkdir -p semantics)."""
        node = self.root
        for p in self._parts(path):
            child = node.children.get(p)
            if child is None:
                child = node.children[p] = DirNode(p)
                self.num_dirs += 1
            elif not isinstance(child, DirNode):
                raise FileExistsError(f"{p!r} exists and is a file")
            node = child
        return node

    def create(self, path: str, replication: int = 3) -> FileNode:
        """The ``open``-for-write RPC: allocate an empty file inode."""
        parts = self._parts(path)
        if not parts:
            raise ValueError("cannot create the root")
        parent = self._walk(parts[:-1])
        if parts[-1] in parent.children:
            raise FileExistsError(f"{path!r} already exists")
        f = FileNode(parts[-1], replication)
        parent.children[parts[-1]] = f
        self.num_files += 1
        return f

    def lookup(self, path: str):
        """The ``lookup`` RPC: path → inode (file or directory)."""
        parts = self._parts(path)
        if not parts:
            return self.root
        parent = self._walk(parts[:-1])
        node = parent.children.get(parts[-1])
        if node is None:
            raise FileNotFoundError(f"no such path: {path!r}")
        return node

    def listdir(self, path: str) -> list[str]:
        node = self.lookup(path)
        if not isinstance(node, DirNode):
            raise NotADirectoryError(path)
        return sorted(node.children)

    def delete(self, path: str) -> None:
        parts = self._parts(path)
        if not parts:
            raise ValueError("cannot delete the root")
        parent = self._walk(parts[:-1])
        node = parent.children.pop(parts[-1], None)
        if node is None:
            raise FileNotFoundError(f"no such path: {path!r}")
        for f in ([node] if isinstance(node, FileNode) else _files_of(node)):
            self.num_files -= 1
        if isinstance(node, DirNode):
            self.num_dirs -= 1 + sum(1 for _ in _dirs_of(node))

    # -- extent map (the commit RPC body) ------------------------------------

    def next_gen(self) -> int:
        self._gen_stamp += 1
        return self._gen_stamp

    def commit_block(self, file: FileNode, size: int,
                     placements: list[int],
                     object_id: int | None = None) -> Block:
        """The ``commit`` RPC: append a written block to a file's extent
        map, stamped with a fresh generation number."""
        if size <= 0:
            raise ValueError(f"block size must be positive, got {size}")
        blk = Block(self._next_block_id, size, self.next_gen(),
                    list(placements), object_id)
        self._next_block_id += 1
        file.blocks.append(blk)
        return blk

    def repoint(self, block: Block, old_node: int, new_node: int) -> None:
        """Replace one replica's home (re-replication), bumping the
        generation stamp so the dead node's copy is fenced as stale."""
        block.placements[block.placements.index(old_node)] = new_node
        block.gen_stamp = self.next_gen()

    # -- whole-tree iteration ------------------------------------------------

    def files(self) -> Iterator[FileNode]:
        yield from _files_of(self.root)

    def blocks(self) -> Iterator[tuple[FileNode, Block]]:
        for f in self.files():
            for b in f.blocks:
                yield f, b

    @property
    def num_blocks(self) -> int:
        return sum(1 for _ in self.blocks())


def _files_of(d: DirNode) -> Iterator[FileNode]:
    for child in d.children.values():
        if isinstance(child, FileNode):
            yield child
        else:
            yield from _files_of(child)


def _dirs_of(d: DirNode) -> Iterator[DirNode]:
    for child in d.children.values():
        if isinstance(child, DirNode):
            yield child
            yield from _dirs_of(child)
