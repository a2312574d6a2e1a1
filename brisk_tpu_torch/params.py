"""Index parameters (mirrors reference brisk/parameters.hpp:9-35).

k     : k-mer size (5..63; k-mers are 2k <= 126 bits)
m     : minimizer size (odd, < k; m-mers are 2m <= 62 bits)
b     : bucket order of magnitude; 4^b buckets keyed by the reduced
        (hashed, truncated) minimizer
"""

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Parameters:
    k: int
    m: int
    b: int

    def __post_init__(self):
        if not (5 <= self.k <= 63):
            raise ValueError(f"k={self.k} out of range [5, 63]")
        if not (1 <= self.m < self.k):
            raise ValueError(f"m={self.m} must be in [1, k)")
        if self.m % 2 != 1:
            # reference asserts m odd (Brisk.hpp:50)
            raise ValueError(f"m={self.m} must be odd")
        if not (1 <= self.b <= self.m):
            raise ValueError(f"b={self.b} must be in [1, m]")

    @property
    def m_reduc(self) -> int:
        """Number of minimizer bases dropped from the bucket key (m - b)."""
        return self.m - self.b

    @property
    def compacted_size(self) -> int:
        """Stored k-mer size once the b bucket bases are implicit (k - b)."""
        return self.k - self.b

    @property
    def n_buckets(self) -> int:
        return 4 ** self.b

    @property
    def suffix_reduc(self) -> int:
        """Low (suffix-side) hashed-minimizer bases dropped for the bucket
        key: (m_reduc + 1) / 2  (reference Brisk.hpp:107)."""
        return (self.m_reduc + 1) // 2

    @property
    def m_mask(self) -> int:
        return (1 << (2 * self.m)) - 1

    @property
    def k_mask(self) -> int:
        return (1 << (2 * self.k)) - 1
