"""Fixture: table mutations without their invalidation (5 findings)."""


class Allocator:
    def __init__(self):
        self._tables = {}
        self.table_version = 0

    def allocate(self, sid, pages):
        self._tables[sid] = pages           # no bump

    def grow(self, sid, page):
        table = self._tables[sid]
        table.append(page)                  # no bump, through an alias

    def free(self, sid):
        del self._tables[sid]               # no bump


class Backend:
    def __init__(self):
        self._dev_tables = None
        self._dev_tables_key = None

    def refresh(self, tables, lens):
        self._dev_tables = (tables, lens)   # no key

    def advance(self, produced):
        tables, lens = self._host_tables()  # not the cached pair
        self._dev_tables = (tables, lens + produced)
