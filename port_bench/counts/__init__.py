"""Operations and bytes counted from shapes and configurations, and the
card's peaks they are held against.  Nothing here reads a clock."""
