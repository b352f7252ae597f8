"""PetscBag: a registered bundle of named problem parameters.

Counterpart of ``petsc_tpu/sys/bag.py``. Behavioral reference: src/sys/classes/bag (PetscBagRegisterReal/Int/Bool/
String/Enum, PetscBagSetFromOptions, PetscBagView, binary load/save). The
reference packs a C struct; here a bag is a typed dict whose entries
register options of the form -<prefix><name> and print PetscBagView-style.
"""

from __future__ import annotations

import numpy as np


class Bag:
    def __init__(self, name="", help="", options=None, prefix=""):
        self._name = name
        self._help = help
        self._prefix = prefix
        self._entries = {}     # name -> [value, kind, help]

    def setName(self, name, help=""):
        self._name, self._help = name, help
        return self

    def setOptionsPrefix(self, p):
        self._prefix = p
        return self

    # ---- registration ----

    def _reg(self, name, value, kind, help):
        self._entries[name] = [value, kind, help]
        return self

    def registerReal(self, name, default, help=""):
        return self._reg(name, float(default), "real", help)

    def registerInt(self, name, default, help=""):
        return self._reg(name, int(default), "int", help)

    def registerBool(self, name, default, help=""):
        return self._reg(name, bool(default), "bool", help)

    def registerString(self, name, default, help=""):
        return self._reg(name, str(default), "string", help)

    def registerEnum(self, name, choices, default, help=""):
        e = self._reg(name, choices[default] if isinstance(default, int)
                      else default, "enum", help)
        self._entries[name].append(tuple(choices))
        return e

    def registerRealArray(self, name, default, help=""):
        return self._reg(name, np.asarray(default, dtype=np.float64),
                         "realarray", help)

    # ---- access ----

    def __getattr__(self, name):
        ent = self.__dict__.get("_entries", {})
        if name in ent:
            return ent[name][0]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._entries[name][0] = value

    def get(self, name):
        return self._entries[name][0]

    # ---- options / view ----

    def setFromOptions(self):
        from .. import config
        o = config.state().options
        for name, ent in self._entries.items():
            kind = ent[1]
            getter = {"real": o.get_real, "int": o.get_int,
                      "bool": o.get_bool, "string": o.get_string,
                      "enum": o.get_string,
                      "realarray": o.get_real_list}[kind]
            v = getter(self._prefix + name, default=None)
            if v is not None:
                if kind == "enum" and v not in ent[3]:
                    from .error import Error
                    raise Error(f"Bag enum {name}: '{v}' not in {ent[3]}")
                ent[0] = np.asarray(v) if kind == "realarray" else v
        return self

    def view(self, file=None):
        import builtins
        p = (lambda *a: print(*a, file=file)) if file else builtins.print
        p(f"PetscBag Object:  {self._name} {self._help}")
        for name, ent in self._entries.items():
            p(f"  {name} = {ent[0]}; {ent[2]}")

    # ---- binary round trip (npz, the reference's checkpoint form) ----

    def save(self, path):
        np.savez(path, **{k: np.asarray(v[0])
                          for k, v in self._entries.items()})

    def load(self, path):
        z = np.load(path, allow_pickle=False)
        for k in z.files:
            if k in self._entries:
                kind = self._entries[k][1]
                v = z[k]
                self._entries[k][0] = {
                    "real": lambda: float(v),
                    "int": lambda: int(v),
                    "bool": lambda: bool(v),
                    "string": lambda: str(v),
                    "enum": lambda: str(v),
                    "realarray": lambda: v,
                }[kind]()
        return self
