"""archiver tool (ref: src/Tools/Archiver/): list / extract / create /
merge cache archives."""

from __future__ import annotations

import os
from typing import List

from ..utils.archive import FileArchive, open_archive
from ..utils.component import ParameterChoice, ParameterString
from .application import Application


class ArchiverTool(Application):
    name = "archiver"
    description = "list/extract/create/merge cache archives"

    mode = ParameterChoice("mode", ["list", "extract", "create", "merge"], default="list")
    archive = ParameterString("archive")
    target = ParameterString("target", default=".")

    def run(self, args: List[str]) -> int:
        if self.mode == "list":
            ar = open_archive(self.archive)
            for name in ar.keys():
                print(name)
            ar.close()
        elif self.mode == "extract":
            ar = open_archive(self.archive)
            names = args or ar.keys()
            os.makedirs(self.target, exist_ok=True)
            for name in names:
                path = os.path.join(self.target, name.replace("/", "__"))
                with open(path, "wb") as fh:
                    fh.write(ar.read(name))
                self.log("extracted", entry=name, path=path)
            ar.close()
        elif self.mode == "create":
            with FileArchive(self.archive, "w") as ar:
                for path in args:
                    with open(path, "rb") as fh:
                        ar.write(os.path.basename(path), fh.read())
        elif self.mode == "merge":
            with FileArchive(self.archive, "a") as out:
                for path in args:
                    src = open_archive(path)
                    for name in src.keys():
                        out.write(name, src.read(name))
                    src.close()
        return 0


if __name__ == "__main__":
    raise SystemExit(ArchiverTool.main())
