"""The port's chunk leases (``repro_torch.core.sweepfabric.LeaseManager``)
against the reference's protocol, in process: the five cases of
``tests/test_sweepfabric.py`` as one parametrised test, each run on the
port's manager and on a directory the two packages share (a lease one
package takes, the other sees, renews around and steals)."""

import os
import time

import pytest

from repro.core import sweepfabric as ref_fabric
from repro_torch.core import sweepfabric


def _claim_is_exclusive(root, a, b, mk):
    assert a.claim(0)
    assert not b.claim(0)                  # O_EXCL: exactly one winner
    assert a.owns(0) and not b.owns(0)
    assert a.holder(0) == "a" and b.holder(0) == "a"
    assert b.claim(1)                      # other chunks unaffected


def _steal_requires_expiry(root, a, b, mk):
    a, b = mk("a", 0.3), mk("b", 0.3)
    assert a.claim(0)
    assert not b.steal_expired(0)          # still live
    time.sleep(0.4)
    assert b.steal_expired(0)              # expired: rename-steal wins
    assert b.owns(0) and not a.owns(0)
    assert a.renew([0]) == [0]             # old holder learns it lost


def _renew_pushes_expiry(root, a, b, mk):
    a, b = mk("a", 0.6), mk("b", 0.6)
    assert a.claim(0)
    time.sleep(0.4)
    assert a.renew([0]) == []              # heartbeat
    time.sleep(0.3)                        # past the ORIGINAL expiry
    assert not b.steal_expired(0)          # renewal kept it alive
    time.sleep(0.4)                        # past the renewed expiry
    assert b.steal_expired(0)


def _torn_file_falls_back_to_mtime(root, a, b, mk):
    a = mk("a", 5.0)
    path = os.path.join(root, "leases", "chunk_0.json")
    with open(path, "w") as fh:
        fh.write('{"worker": "dead", "exp')   # torn mid-write
    assert not a.steal_expired(0)          # fresh mtime: not stealable yet
    os.utime(path, (time.time() - 60, time.time() - 60))
    assert a.steal_expired(0)              # old + unreadable = expired
    assert a.owns(0)


def _release_only_own(root, a, b, mk):
    assert a.claim(3)
    b.release(3)                           # not b's to drop
    assert a.owns(3)
    a.release(3)
    assert a.holder(3) is None
    assert b.claim(3)                      # released chunk claimable again


CASES = {"claim_is_exclusive": _claim_is_exclusive,
         "steal_requires_expiry": _steal_requires_expiry,
         "renew_pushes_expiry": _renew_pushes_expiry,
         "torn_file_falls_back_to_mtime": _torn_file_falls_back_to_mtime,
         "release_only_own": _release_only_own}


@pytest.mark.parametrize("case", list(CASES))
def test_lease_protocol(tmp_path, case):
    """Each case on the port's managers alone, then with holder ``a`` the
    port's and rival ``b`` the reference's, then the other way round: the
    lease files are one protocol across the packages."""
    for kinds in (("port", "port"), ("port", "ref"), ("ref", "port")):
        root = str(tmp_path / "-".join(kinds))
        cls = {"port": sweepfabric.LeaseManager,
               "ref": ref_fabric.LeaseManager}

        def mk(name, ttl=sweepfabric.DEFAULT_TTL_S):
            return cls[kinds[0] if name == "a" else kinds[1]](
                root, name, ttl_s=ttl)

        CASES[case](root, mk("a"), mk("b"), mk)
