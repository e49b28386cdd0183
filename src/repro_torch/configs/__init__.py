"""The paper's workload configurations (HAR) and Seeker's system knobs."""
