"""Fixture: every table mutation invalidates (0 findings)."""


class Allocator:
    def __init__(self):
        self._tables = {}
        self.table_version = 0

    def allocate(self, sid, pages):
        self._tables[sid] = pages
        self.table_version += 1

    def length(self, sid):
        return len(self._tables.get(sid, []))     # a read


class Backend:
    def __init__(self):
        self._dev_tables = None
        self._dev_tables_key = None

    def refresh(self, kv, tables, lens):
        self._dev_tables = (tables, lens)
        self._dev_tables_key = kv.table_version

    def fused_decode(self, impl):
        tables_d, lens_d = self._dev_tables
        lens_d = impl(tables_d, lens_d)
        self._dev_tables = (tables_d, lens_d)     # derived in place
